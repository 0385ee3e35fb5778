"""The port's fused CGConv eval op (ops/fused_cgconv.py) against the JAX
package's ``fused_cgconv_eval``: the Pallas kernel run in interpret mode
(whole range and a bounded window) and the structured ``'xla'`` twin.
Same numpy inputs on both sides; f32, rtol 1e-4 / atol 1e-5. The CUDA
kernel itself runs only on the card (chip_smoke.py); here its wrapper must
refuse what is not a CUDA tensor instead of falling back."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.data.graph import pack_graphs
from cgnn_tpu.ops import pallas_cgconv as jops
from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.ops import fused_cgconv as tops
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

F, M = 16, 8
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed=0):
    """A real packed dense batch (padding rows and masked slots included)
    with random node features and conv parameters."""
    graphs = load_synthetic(14, FeaturizeConfig(radius=5.0, max_num_nbr=M),
                            seed=2, max_atoms=6)
    n_real = sum(g.num_nodes for g in graphs)
    nc = -(-(n_real + 11) // 8) * 8
    b = pack_graphs(graphs, nc, nc * M, 16, dense_m=M)
    g = b.edges.shape[-1]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        nodes=rng.standard_normal((nc, F)).astype(f32),
        edges=np.asarray(b.edges, f32),
        kernel=(rng.standard_normal((2 * F + g, 2 * F))
                / np.sqrt(2 * F + g)).astype(f32),
        bias=rng.standard_normal(2 * F).astype(f32) * f32(0.1),
        scale=rng.uniform(0.5, 1.5, 2 * F).astype(f32),
        bn_bias=rng.standard_normal(2 * F).astype(f32) * f32(0.2),
        neighbors=np.asarray(b.neighbors, np.int32),
        edge_mask=np.asarray(b.edge_mask, f32).reshape(nc, M),
        mean=rng.standard_normal(2 * F).astype(f32) * f32(0.3),
        var=rng.uniform(0.5, 2.0, 2 * F).astype(f32),
    )


_ORDER = ("nodes", "edges", "kernel", "bias", "scale", "bn_bias",
          "neighbors", "edge_mask", "mean", "var")


def _jax(inp, **kw):
    return np.asarray(jops.fused_cgconv_eval(
        *(jnp.asarray(inp[k]) for k in _ORDER), **kw))


def _torch(inp, device="cpu", **kw):
    out = tops.fused_cgconv_eval(
        *(torch.from_numpy(inp[k]).to(device) for k in _ORDER), **kw)
    return out.cpu().numpy()


@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
@pytest.mark.parametrize("jax_case", ["pallas", "pallas_window", "xla"])
def test_fused_eval_matches_jax(jax_case, port_impl):
    inp = _inputs()
    if jax_case == "xla":
        want = _jax(inp, impl="xla")
    else:
        window = jops.window_width(6) if jax_case == "pallas_window" else 0
        with jops.interpret_mode():
            want = _jax(inp, impl="pallas", window=window)
    got = _torch(inp, impl=port_impl)
    assert got.shape == want.shape == (inp["nodes"].shape[0], F)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


STATS_RTOL = 1e-4  # column sums over every slot, another order: held to
                  # rtol of each row's largest entry


@pytest.mark.parametrize("jax_case", ["pallas", "pallas_window"])
def test_factored_stats_match_jax(jax_case):
    """Kernel 2's factored plain pieces — the node projections P, then the
    stats from P — composed, against the JAX stats kernel in interpret
    mode (whole range and a bounded window) and against the port's
    unfactored plain version, on the same numpy inputs (NaN edges in
    padding slots selected away)."""
    inp = _inputs(seed=4)
    masked = inp["edge_mask"] == 0
    assert masked.any()
    inp["edges"] = inp["edges"].copy()
    inp["edges"][masked] = np.nan
    shift = inp["mean"]  # any [2F] vector
    j = {k: jnp.asarray(inp[k]) for k in _ORDER}
    window = jops.window_width(6) if jax_case == "pallas_window" else 0
    with jops.interpret_mode():
        want = np.asarray(jops._pallas_stats(
            j["nodes"], j["edges"], j["kernel"], j["bias"], j["neighbors"],
            j["edge_mask"], jnp.asarray(shift), window))
    t = {k: torch.from_numpy(inp[k]) for k in _ORDER}
    p = tops.node_projections_reference(t["nodes"], t["kernel"], t["bias"])
    n = inp["nodes"].shape[0]
    assert p.shape == (n, 4 * F)
    got = tops.stats_from_projections_reference(
        p, t["edges"], t["kernel"], t["neighbors"], t["edge_mask"],
        torch.from_numpy(shift)).numpy()
    plain = tops.fused_cgconv_stats_reference(
        t["nodes"], t["edges"], t["kernel"], t["bias"], t["neighbors"],
        t["edge_mask"], torch.from_numpy(shift)).numpy()
    assert got.shape == want.shape == (2, 2 * F)
    assert np.isfinite(got).all()
    for ref in (want, plain):
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(got - ref) <= STATS_RTOL * scale).all()


def test_node_projections_are_the_z_terms():
    """P[i, 0:2F] + P[j, 2F:4F] + e . W_e is the structured z of slot
    (i, j) (f32, rtol 1e-4 / atol 1e-5)."""
    inp = _inputs(seed=5)
    t = {k: torch.from_numpy(inp[k]) for k in _ORDER}
    p = tops.node_projections_reference(t["nodes"], t["kernel"], t["bias"])
    n = inp["nodes"].shape[0]
    nbr = t["neighbors"].reshape(-1).long()
    z = (p[:, None, :2 * F] + p[nbr, 2 * F:].reshape(n, M, 2 * F)
         + t["edges"] @ t["kernel"][2 * F:])
    want = tops._z_structured(t["nodes"], t["edges"], t["kernel"], t["bias"],
                              t["neighbors"], torch.float32)
    torch.testing.assert_close(z, want, **TOL)


def test_padding_slots_are_selected_not_multiplied():
    """A NaN in a masked slot's edge row must not reach the sum."""
    inp = _inputs(seed=1)
    clean = _torch(inp, impl="pallas")
    masked = inp["edge_mask"] == 0
    assert masked.any()
    poisoned = dict(inp, edges=inp["edges"].copy())
    poisoned["edges"][masked] = np.nan
    np.testing.assert_array_equal(_torch(poisoned, impl="pallas"), clean)


def test_cuda_wrapper_refuses_non_cuda_tensors():
    args = [torch.from_numpy(_inputs()[k]) for k in _ORDER]
    before = tops.fused_cgconv_eval_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.fused_cgconv_eval_cuda(*args)
    # a tensor that is not on the CPU takes the kernel route, which
    # raises: 'pallas' never falls back to the plain version
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.fused_cgconv_eval(*meta, impl="pallas")
    assert tops.fused_cgconv_eval_cuda.launches == before
    with pytest.raises(ValueError, match="impl"):
        tops.fused_cgconv_eval(*args, impl="triton")


def test_cuda_tensor_without_cuda_raises(monkeypatch):
    from cgnn_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["fused_cgconv"])


def test_cost_model():
    want = jops.fused_conv_hbm_bytes(1784, 12, 41, 64)
    assert tops.fused_conv_hbm_bytes(1784, 12, 41, 64) == want
    # a hand-counted case: N=4, M=2, F=2, G=3; rows 0 and 2 have real
    # slots (pointing at nodes 1, 2, 2), row 1 only padding that points at
    # node 3, row 3 nothing: nodes 0, 1, 2 are touched, node 3 is not
    n, m, f, g = 4, 2, 2, 3
    nbr = torch.tensor([[1, 3], [3, 3], [2, 2], [0, 0]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 0.0], [0.0, 0.0], [1.0, 1.0], [0.0, 0.0]])
    assert tops.touched_nodes(nbr, mask, n) == 3
    assert tops.touched_nodes(nbr.reshape(-1), mask.reshape(-1), n) == 3
    nbytes = 4 * (n * f + n * m * g + 2 * n * m + (2 * f + g) * 2 * f
                  + 4 * 2 * f + n * f)
    cost = tops.eval_pass_cost(n, m, g, f, real_slots=3, touched=3)
    # 3 nodes x (2 F 4F = 32) + 3 slots x (2 G 2F = 24)
    assert cost == {"bytes": nbytes, "flops": 3 * 32 + 3 * 24}
    # z taken whole per slot (the first designs' work, the "before"
    # count): 2 rows x 2F x 2F (v_i) + 3 slots x 2F x 2 (F + G)
    assert tops.unfactored_flops(f, g, 3, 2) == 2 * 16 + 3 * 40 == 152
    # the stats pass at the least work: the factored z of the eval pass,
    # plus the moments' 3 ops per real slot and channel
    stats = tops.stats_pass_cost(n, m, g, f, real_slots=3, touched=3)
    assert stats == {"bytes": nbytes - 4 * n * f,
                     "flops": 3 * 32 + 3 * 24 + 3 * 3 * 2 * f}
    # the flagship's top serving rung, every slot real, every node touched
    n, m, g, f = 1784, 12, 41, 64
    stats = tops.stats_pass_cost(n, m, g, f, real_slots=n * m, touched=n)
    assert stats["flops"] == (2 * f * 4 * f * n + 2 * g * 2 * f * n * m
                              + 3 * n * m * 2 * f)
    assert tops.eval_pass_cost(n, m, g, f, n * m, n)["flops"] == (
        2 * f * 4 * f * n + 2 * g * 2 * f * n * m)
    # ... which is under half the count of z taken whole per slot
    assert 2 * stats["flops"] < (tops.unfactored_flops(f, g, n * m, n)
                                 + 3 * n * m * 2 * f)


def test_build_resolves_each_entry_once(monkeypatch):
    """A kernel's ctypes entry is looked up in its library once; later
    calls take it from the cache, without ``load`` or its lock."""
    calls = []

    class Lib:
        def __init__(self):
            self.segment_sum_sorted_f32 = types.SimpleNamespace(
                argtypes=None, restype=None)

    def load(name):
        calls.append(name)
        return Lib()

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_entries", {})
    fns = [_build.entry("segment_sum", "segment_sum_sorted_f32", 3, 2)
           for _ in range(50)]
    assert calls == ["segment_sum"]
    assert all(fn is fns[0] for fn in fns)
    assert len(fns[0].argtypes) == 3 + 2 + 1 and fns[0].restype is not None