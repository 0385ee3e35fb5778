"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version at shapes and inputs the CPU tests cannot reach (ragged
widths, G > F, rows that are all padding, NaN in masked slots). Marked
``cuda``; they skip where there is no card. On a GPU machine, from the
repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
need not have; this file imports none of it.)
"""

import numpy as np
import pytest
import torch

from cgnn_tpu_torch.ops import fused_cgconv as fc

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-5)  # f32, sums reordered against the plain version


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _args(dev, n, m, f, g, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = (rng.random((n, m)) > 0.3).astype(f32)
    mask[-min(3, n):] = 0.0  # trailing padding rows
    edges = rng.random((n, m, g)).astype(f32)
    edges[mask == 0] = np.nan  # must be selected away, never multiplied

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (
        t(rng.standard_normal((n, f)).astype(f32)),
        t(edges),
        t((rng.standard_normal((2 * f + g, 2 * f))
           / np.sqrt(2 * f + g)).astype(f32)),
        t((0.1 * rng.standard_normal(2 * f)).astype(f32)),
        t(rng.uniform(0.5, 1.5, 2 * f).astype(f32)),
        t((0.2 * rng.standard_normal(2 * f)).astype(f32)),
        t(rng.integers(0, n, n * m).astype(np.int32)),
        t(mask),
        t((0.3 * rng.standard_normal(2 * f)).astype(f32)),
        t(rng.uniform(0.5, 2.0, 2 * f).astype(f32)),
    )


@pytest.mark.parametrize("n,m,f,g", [
    (1784, 12, 64, 41),  # the flagship's top serving rung
    (4, 1, 64, 41),  # fewer rows than one block
    (37, 8, 16, 26),  # the CPU tests' widths
    (100, 12, 32, 100),  # G > F: each thread stages several edge columns
    (129, 5, 96, 7),  # F not a power of two, 768 threads a block
])
def test_kernel_matches_plain_version(dev, n, m, f, g):
    args = _args(dev, n, m, f, g)
    before = fc.fused_cgconv_eval_cuda.launches
    got = fc.fused_cgconv_eval_cuda(*args)
    torch.cuda.synchronize()
    assert fc.fused_cgconv_eval_cuda.launches == before + 1
    want = fc.fused_cgconv_eval_reference(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    assert (got[-min(3, n):] == 0).all()  # all-padding rows sum nothing
    # the public op routes a CUDA tensor to the kernel
    torch.testing.assert_close(fc.fused_cgconv_eval(*args, impl="pallas"),
                               got, rtol=0, atol=0)


def test_kernel_refuses_what_it_does_not_take(dev):
    args = list(_args(dev, 16, 4, 16, 8))
    bad_dtype = list(args)
    bad_dtype[6] = args[6].long()
    with pytest.raises(ValueError, match="neighbors must be torch.int32"):
        fc.fused_cgconv_eval_cuda(*bad_dtype)
    strided = list(args)
    strided[0] = torch.empty(16, 32, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_cgconv_eval_cuda(*strided)
    mixed = list(args)
    mixed[3] = args[3].cpu()
    with pytest.raises(ValueError, match="bias is on cpu"):
        fc.fused_cgconv_eval_cuda(*mixed)
    # W [(2F+G), 2F] must fit one block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        fc.fused_cgconv_eval_cuda(*_args(dev, 8, 2, 128, 7))


def test_model_kernel_path_matches_plain_path(dev):
    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.serve.shapes import plan_shape_set

    dcfg = DataConfig(max_num_nbr=8)
    graphs = load_synthetic(40, dcfg.featurize_config(), seed=3)
    batch = plan_shape_set(graphs, 40, rungs=1, dense_m=8).pack_full(graphs)
    outs = []
    for impl in ("pallas", ""):
        cfg = ModelConfig(atom_fea_len=32, n_conv=2, dense_m=8,
                          cgconv_impl=impl)
        net = build_model(cfg, dcfg, device=dev)
        net.load_state_dict(convert.from_flax_variables(
            convert.init_params(cfg, dcfg, seed=1)))
        with torch.inference_mode():
            outs.append(net(batch.to(dev)))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
