"""Kernel 8's radius cut on d2: ``radius_threshold(r)`` is the largest f32
T whose correctly rounded root is <= r, so that ``d2 <= T`` decides exactly
what ``sqrt_rn(d2) <= r`` decides, the plain version's radius test on the
card. Held here on the CPU, for the radii the repo uses and 50 seeded
random radii in [1, 12] Å, with two correctly rounded roots: numpy's
float32 sqrt, and ``torch.sqrt`` taken in float64 and rounded to float32.
(``torch.sqrt`` of a contiguous float32 CPU tensor goes through MKL's
vector math at 1 ulp and is not correctly rounded, so it is not one.)"""

import numpy as np
import pytest
import torch

from cgnn_tpu_torch.config import DataConfig
from cgnn_tpu_torch.ops.neighbor_search import radius_threshold

F32 = np.float32
RADII = ([8.0, 6.0, 5.0, DataConfig().radius]
         + [float(r) for r in np.random.default_rng(7).uniform(1, 12, 50)])


def _up(x, n=1):
    for _ in range(n):
        x = np.nextafter(x, F32(np.inf))
    return x


def _down(x, n=1):
    for _ in range(n):
        x = np.nextafter(x, F32(-np.inf))
    return x


def _torch_sqrt_rn(x):
    """sqrt_rn of float32 ``x`` through torch on the CPU: the float64 root
    rounded to float32 (exact: the double root of a float rounds once)."""
    return torch.sqrt(torch.from_numpy(x).double()).float().numpy()


@pytest.mark.parametrize("radius", RADII,
                         ids=[f"r{i}_{r:.4f}" for i, r in enumerate(RADII)])
def test_d2_threshold_decides_as_the_root(radius):
    r = F32(radius)
    t = F32(radius_threshold(radius))
    assert t.dtype == F32 and float(t) == radius_threshold(radius)
    # T's root is within the radius, the next f32's is not; numpy and
    # torch take the same correctly rounded root
    pair = np.array([t, _up(t)], F32)
    roots = np.sqrt(pair)
    np.testing.assert_array_equal(roots, _torch_sqrt_rn(pair))
    assert roots[0] <= r < roots[1]

    # 10^5 d2 values around r^2: the 4 ulps either side of T, then seeded
    # values within 1% of r^2 and a run of consecutive f32s through r^2
    rng = np.random.default_rng(int(radius * 1e6))
    near = np.array([_down(t, n) for n in range(4, 0, -1)] + [t]
                    + [_up(t, n) for n in range(1, 5)], F32)
    r2 = r * r
    run = r2.view(np.int32) + np.arange(-2000, 2000, dtype=np.int32)
    spread = (r2 * rng.uniform(0.99, 1.01, 100_000 - near.size - run.size)
              ).astype(F32)
    d2 = np.concatenate([near, run.view(F32), spread])
    assert d2.size == 100_000
    by_cut = d2 <= t
    np.testing.assert_array_equal(by_cut, np.sqrt(d2) <= r)
    np.testing.assert_array_equal(by_cut, _torch_sqrt_rn(d2) <= r)
    assert by_cut[:5].all() and not by_cut[5:9].any()


@pytest.mark.parametrize("radius", [np.inf, np.nan, -1.0, -1e-30, 1e39],
                         ids=["inf", "nan", "negative", "tiny_negative",
                              "past_f32"])
def test_threshold_refuses_radii_outside_f32_range(radius):
    # no largest f32 exists for these (or the walk would not end): refused
    with pytest.raises(ValueError, match="outside"):
        radius_threshold(radius)


@pytest.mark.parametrize("radius", [0.0, 1e30])
def test_threshold_at_the_range_ends(radius):
    # r = 0 cuts at d2 = 0; a radius whose square overflows f32 cuts at
    # the largest finite f32 (inf fails both forms)
    r = F32(radius)
    t = F32(radius_threshold(radius))
    with np.errstate(over="ignore"):
        assert np.sqrt(t) <= r < np.sqrt(_up(t))
    assert t == (F32(0) if radius == 0 else np.finfo(F32).max)
