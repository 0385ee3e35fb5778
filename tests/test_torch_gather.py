"""Kernel 7's op, the windowed neighbor gather (ops/windowed_gather.py),
against the JAX package's ``windowed_gather`` (its Pallas kernel in
interpret mode) on the same numpy inputs: bit-exact, out-of-window zeros
included. Inputs are finite: the JAX kernel's one-hot matmul would spread
a non-finite window row over its block (0 * inf), where the port selects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cgnn_tpu.ops import pallas_gather
from cgnn_tpu.ops.pallas_cgconv import _win_starts
from cgnn_tpu_torch.ops import windowed_gather as wg


def _jax(nodes, nbr, ws, window):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pallas_gather.windowed_gather(
            jnp.asarray(nodes), jnp.asarray(nbr), jnp.asarray(ws), window))


def _port(nodes, nbr, ws, window, impl="pallas"):
    before = wg.windowed_gather_cuda.launches
    out = wg.windowed_gather(torch.from_numpy(nodes), torch.from_numpy(nbr),
                             torch.from_numpy(ws), window, impl=impl)
    assert wg.windowed_gather_cuda.launches == before  # CPU: plain version
    return out.numpy()


def _case(name):
    """(nodes, neighbors, win_starts, window) of one named case."""
    rng = np.random.default_rng(0)
    if name == "test_ops":  # tests/test_ops.py's case
        nodes = rng.normal(size=(256, 8)).astype(np.float32)
        nbr = np.concatenate([rng.integers(0, 128, size=128 * 4),
                              rng.integers(128, 256, size=128 * 4)])
        return nodes, nbr.astype(np.int32), np.array([0, 128], np.int32), 256
    nodes = rng.normal(size=(512, 16)).astype(np.float32)
    m = 3
    if name == "out_of_window":
        # every block's window is [128 b, 128 b + 128) after alignment;
        # about three quarters of the indices fall outside it: zeros
        nbr = rng.integers(0, 512, size=512 * m).astype(np.int32)
        return nodes, nbr, np.array([0, 128, 256, 384], np.int32), 128
    if name == "clamped_last_block":
        # unaligned starts that reach past N - window: the last blocks
        # clamp to 512 - 256 = 256, the others align down
        nbr = np.repeat(np.arange(512), m).astype(np.int32)
        nbr[-40:] = rng.integers(200, 512, size=40)
        return nodes, nbr, np.array([5, 130, 300, 470], np.int32), 256
    raise KeyError(name)


@pytest.mark.parametrize("name", ["test_ops", "out_of_window",
                                  "clamped_last_block"])
def test_windowed_gather_matches_jax(name):
    nodes, nbr, ws, window = _case(name)
    want = _jax(nodes, nbr, ws, window)
    got = _port(nodes, nbr, ws, window)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port(nodes, nbr, ws, window, "xla"), got)
    # the window contract, by hand
    n, m = nodes.shape[0], nbr.size // nodes.shape[0]
    starts = np.minimum(ws, max(n - window, 0)) // 128 * 128
    start = np.repeat(starts, 128 * m)
    inside = (nbr >= start) & (nbr < start + window)
    flat = got.reshape(n * m, -1)
    np.testing.assert_array_equal(flat[inside], nodes[nbr[inside]])
    assert (flat[~inside] == 0).all()
    if name == "out_of_window":
        assert 0.15 < inside.mean() < 0.35
    else:
        assert inside.all() or name == "clamped_last_block"


@pytest.mark.parametrize("maxg", [1, 6, 40, 130])
def test_window_width_and_starts_match_jax(maxg):
    window = wg.window_width(maxg)
    assert window == pallas_gather.window_width(maxg)
    for n_pad in (window, 4 * 128, 16 * 128):
        if n_pad < window:
            continue
        nb = n_pad // 128
        np.testing.assert_array_equal(
            wg.window_starts(nb, n_pad, window),
            np.asarray(_win_starts(nb, n_pad, window)))


def test_windowed_gather_refuses_what_jax_refuses():
    nodes, nbr, ws, _ = _case("test_ops")
    t = torch.from_numpy
    with pytest.raises(ValueError, match="multiple of 128"):
        wg.windowed_gather(t(nodes[:200]), t(nbr[:800]), t(ws), 128)
    with pytest.raises(ValueError, match="window"):
        wg.windowed_gather(t(nodes), t(nbr), t(ws), 200)
    with pytest.raises(ValueError, match="window"):
        wg.windowed_gather(t(nodes), t(nbr), t(ws), 384)
    with pytest.raises(ValueError, match="N \\* M"):
        wg.windowed_gather(t(nodes), t(nbr[:-1]), t(ws), 256)
    with pytest.raises(ValueError, match="CUDA"):
        wg.windowed_gather_cuda(t(nodes), t(nbr), t(ws), 256)
