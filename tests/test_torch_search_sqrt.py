"""The plain neighbor search takes a correctly rounded square root on the
CPU, as kernel 8 and the JAX package do.

``torch.sqrt`` of a contiguous f32 CPU tensor goes through a vector
library that is off by an ulp on some inputs; ``sqrt_rn`` takes the root
in f64 and rounds once to f32, which is exact. Held here:

- on 10^6 seeded d² values in [1, 144], ``sqrt_rn`` is bit-equal to
  numpy's f32 ``np.sqrt`` (correctly rounded);
- on the cells of tests/test_torch_rawwire.py, the plain search's
  distances are bit-equal to ``np.sqrt`` of a numpy mirror of its own d²,
  and its neighbors, edge mask, edge counts and overflow flags are
  bit-equal to the JAX package's. Its distances are bit-equal to the JAX
  package's too, except where XLA's CPU backend contracts the JAX side's
  d² sum ``diff0*diff0 + diff1*diff1 + diff2*diff2``
  (``cgnn_tpu/ops/neighbor_search.py`` ``_candidate_distances``) into
  fused multiply-adds, which round once where the port rounds twice:
  those are held to 1 ulp, and shown to come from that op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.data import rawbatch as jr
from cgnn_tpu.ops import neighbor_search as jns
from cgnn_tpu_torch.data import rawbatch as tr
from cgnn_tpu_torch.ops import neighbor_search as tns
from test_torch_rawwire import CASES, _port_raw, _port_spec


def test_sqrt_rn_is_correctly_rounded_on_a_million_values():
    rng = np.random.default_rng(0)
    d2 = rng.uniform(1.0, 144.0, 10**6).astype(np.float32)
    got = tns.sqrt_rn(torch.from_numpy(d2)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sqrt(d2))
    # the lattice-plane norms of needed_images take the same root
    lats = rng.normal(0, 4, (256, 3, 3)).astype(np.float32)
    want = np.stack([tr.needed_images_f32(a, 6.0) for a in lats])
    np.testing.assert_array_equal(
        tns.needed_images(torch.from_numpy(lats), 6.0).numpy(), want)


def _numpy_d2(frac, lat, offsets):
    """The plain version's d² in numpy, op for op (one rounding a
    product and a sum, no fused multiply-add) -> [S, S*K]."""
    def rows(x):
        return (x[..., 0:1] * lat[0] + x[..., 1:2] * lat[1]) \
            + x[..., 2:3] * lat[2]

    pos = rows(frac)[:, None, :] + rows(offsets)[None]
    diff = pos[None] - rows(frac)[:, None, None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    return d2.reshape(frac.shape[0], -1)


def _select(d, amask, spec):
    """The search's selection in numpy from candidate distances d [S,
    S*K]: the first M valid candidates in (distance, index) order ->
    (neighbors, distances, edge mask)."""
    s, k, m = d.shape[0], spec.n_images, spec.dense_m
    live = amask > 0
    valid = (live[:, None, None] & live[None, :, None]
             & ~(np.eye(s, dtype=bool)[:, :, None]
                 & (np.arange(k) == spec.home_image)[None, None, :]))
    valid = valid.reshape(s, s * k) & (d <= np.float32(spec.radius))
    key = np.where(valid, d, np.float32(np.inf))
    order = np.argsort(key, axis=1, kind="stable")[:, :m]
    em = np.arange(m)[None, :] < valid.sum(axis=1)[:, None]
    nbr = np.where(em, order // k, np.arange(s)[:, None]).astype(np.int32)
    dist = np.where(em, np.take_along_axis(key, order, 1), np.float32(0))
    return nbr, dist.astype(np.float32), em.astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_search_bit_equal_to_jax_and_numpy(case):
    js, raws, g_cap = CASES[case]
    ts = _port_spec(js)
    jrb = jr.pack_raw(raws, g_cap, js)
    trb = tr.pack_raw([_port_raw(r) for r in raws], g_cap, ts)
    want = [np.asarray(x) for x in jax.jit(
        lambda rb: jns.neighbor_search(rb.frac, rb.lattices, rb.atom_mask,
                                       js, impl="xla"))(jrb)]
    got = [x.numpy() for x in tns.neighbor_search(
        trb.frac, trb.lattices, trb.atom_mask, ts, impl="xla")]
    for name, a, b in zip(("neighbors", "edge_mask", "n_edges", "overflow"),
                          [got[0]] + got[2:], [want[0]] + want[2:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the port: np.sqrt (correctly rounded) of a numpy mirror of its own
    # d², selected in numpy, bit for bit
    offsets = ts.offsets_grid().astype(np.float32)
    jax_d = np.asarray(jax.jit(jax.vmap(
        lambda f, l: jns._candidate_distances(
            f, l, jnp.asarray(offsets))))(jrb.frac, jrb.lattices))
    for gi in range(g_cap):
        amask = trb.atom_mask[gi].numpy()
        mirror = _select(np.sqrt(_numpy_d2(trb.frac[gi].numpy(),
                                           trb.lattices[gi].numpy(),
                                           offsets)), amask, ts)
        for name, a, b in zip(("neighbors", "distances", "edge_mask"),
                              got[:3], mirror):
            np.testing.assert_array_equal(a[gi], b, err_msg=name)
        # the JAX search's distances are its own candidate distances
        # (d² fused by XLA, then a correctly rounded root), selected the
        # same way
        np.testing.assert_array_equal(
            _select(jax_d[gi], amask, ts)[1], want[1][gi])
    diff = got[1] != want[1]
    # where the two sides' d² sums round apart (the JAX side's fused
    # multiply-adds), the distances differ by at most 1 ulp
    assert int(_ulps(got[1], want[1]).max(initial=0)) <= 1
    if case != "synthetic":  # cells whose d² take no rounding in a sum
        assert not diff.any()
