"""The port's fused CGConv eval op (ops/fused_cgconv.py) against the JAX
package's ``fused_cgconv_eval``: the Pallas kernel run in interpret mode
(whole range and a bounded window) and the structured ``'xla'`` twin.
Same numpy inputs on both sides; f32, rtol 1e-4 / atol 1e-5. The CUDA
kernel itself runs only on the card (chip_smoke.py); here its wrapper must
refuse what is not a CUDA tensor instead of falling back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.data.graph import pack_graphs
from cgnn_tpu.ops import pallas_cgconv as jops
from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.ops import fused_cgconv as tops

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
    n, m, g, f = 1784, 12, 41, 64
    cost = tops.eval_pass_cost(n, m, g, f, real_slots=n * m, real_rows=n)
    assert cost["bytes"] == 4 * (n * f + n * m * g + 2 * n * m
                                 + (2 * f + g) * 2 * f + 4 * 2 * f + n * f)
    assert cost["flops"] == 2 * (n * f * 2 * f + n * m * (f + g) * 2 * f)
