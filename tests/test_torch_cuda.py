"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version at shapes and inputs the CPU tests cannot reach (ragged
widths, G > F, rows that are all padding, NaN in masked slots), the
fixed-order reductions (kernels 2 and 4) bit-identical from run to run,
and the training op's kernel path against its structured twin. Marked
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


def _close_on_scale(got, want, rtol=1e-4):
    """Column sums over up to ~10^5 slots, added in another order: held to
    rtol of the largest entry (a sum near 0 has no relative digits)."""
    assert torch.isfinite(got).all()
    scale = float(want.abs().max().clamp_min(1e-6))
    assert float((got - want).abs().max()) <= rtol * scale


@pytest.mark.parametrize("n,m,f,g", [
    (1784, 12, 64, 41), (4, 1, 64, 41), (37, 8, 16, 26), (100, 12, 32, 100),
    (129, 5, 96, 7),
])
def test_stats_kernel_matches_plain_version(dev, n, m, f, g):
    """Kernel 2 (NaN edges in masked slots, trailing all-padding rows):
    against its plain version, and bit-identical when run again."""
    nodes, edges, kernel, bias, _, _, nbr, mask, shift, _ = _args(
        dev, n, m, f, g)
    before = fc.fused_cgconv_stats_cuda.launches
    got = fc.fused_cgconv_stats_cuda(nodes, edges, kernel, bias, nbr, mask,
                                     shift)
    again = fc.fused_cgconv_stats_cuda(nodes, edges, kernel, bias, nbr, mask,
                                       shift)
    torch.cuda.synchronize()
    assert fc.fused_cgconv_stats_cuda.launches == before + 2
    want = fc.fused_cgconv_stats_reference(nodes, edges, kernel, bias, nbr,
                                           mask, shift)
    assert torch.equal(got, again)
    for row in range(2):
        _close_on_scale(got[row], want[row])


def _epilogue_args(dev, n, m, f, seed=0):
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    rng = np.random.default_rng(seed)
    mask = (rng.random((n, m)) > 0.3).astype(np.float32)
    mask[-min(3, n):] = 0.0
    z = rng.normal(0.5, 1.5, (n, m, 2 * f)).astype(np.float32)
    z[mask == 0] = np.nan  # must be selected away, never multiplied

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    cst = t(np.stack([rng.normal(0.5, 0.2, 2 * f),
                      1.0 / rng.uniform(1.2, 1.8, 2 * f),
                      rng.uniform(0.5, 1.5, 2 * f),
                      0.2 * rng.standard_normal(2 * f)]))
    ct = t(rng.standard_normal((n, f)))
    n_real = float(mask.sum())
    red5 = torch.cat([t(rng.standard_normal((4, 2 * f))),
                      torch.full((1, 2 * f), 1.0 / max(n_real, 1.0),
                                 device=dev)])
    return fe, t(z), t(mask), cst, ct, red5


_EPI_SHAPES = [(7000, 12, 64), (4, 1, 64), (37, 8, 16), (129, 5, 96),
               (50, 12, 40)]


@pytest.mark.parametrize("n,m,f", _EPI_SHAPES)
def test_epilogue_kernels_match_plain_versions(dev, n, m, f):
    """Kernels 3, 4 and 5 (NaN z in masked slots, all-padding rows)
    against their plain versions; kernel 4 bit-identical when run again."""
    fe, z, mask, cst, ct, red5 = _epilogue_args(dev, n, m, f)
    counts = [w.launches for w in (fe.epilogue_apply_cuda,
                                   fe.epilogue_reduce_cuda,
                                   fe.epilogue_dz_cuda)]
    agg = fe.epilogue_apply_cuda(z, mask, cst)
    red = fe.epilogue_reduce_cuda(z, mask, cst, ct)
    red_again = fe.epilogue_reduce_cuda(z, mask, cst, ct)
    dz = fe.epilogue_dz_cuda(z, mask, cst, red5, ct)
    torch.cuda.synchronize()
    assert [fe.epilogue_apply_cuda.launches, fe.epilogue_reduce_cuda.launches,
            fe.epilogue_dz_cuda.launches] == [counts[0] + 1, counts[1] + 2,
                                              counts[2] + 1]
    torch.testing.assert_close(agg, fe.epilogue_apply_reference(z, mask, cst),
                               **TOL)
    assert (agg[-min(3, n):] == 0).all()
    assert torch.equal(red, red_again)
    want_red = fe.epilogue_reduce_reference(z, mask, cst, ct)
    for row in range(4):
        _close_on_scale(red[row], want_red[row], rtol=5e-4)
    assert torch.isfinite(dz).all()
    torch.testing.assert_close(
        dz, fe.epilogue_dz_reference(z, mask, cst, red5, ct), **TOL)
    assert (dz[mask == 0] == 0).all()


def test_training_op_kernel_path_matches_structured_twin(dev):
    """fused_cgconv on the card: 'pallas' (kernels 1, 2, 4, 5) against
    'xla' (the structured twin with autograd), values, stats and grads,
    with the two-tier transpose mapping of a real packed batch."""
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for

    graphs = load_synthetic_mp(48, seed=5)
    nc, ec = capacities_for(graphs, 48, dense_m=12)
    batch = next(iter(batch_iterator(graphs, 48, nc, ec, dense_m=12,
                                     snug=True))).to(dev)
    n = batch.nodes.shape[0]
    f, g = 64, batch.edges.shape[-1]
    rng = np.random.default_rng(2)

    def leaf(shape, s=1.0):
        return torch.tensor(s * rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)

    inputs = [leaf((n, f)), leaf((2 * f + g, 2 * f), (2 * f + g) ** -0.5),
              leaf(2 * f, 0.1), 1.0 + leaf(2 * f, 0.1), leaf(2 * f, 0.2)]
    ct = leaf((n, f))
    tr = (batch.in_slots, batch.in_mask, batch.over_slots, batch.over_nodes,
          batch.over_mask)
    res = []
    for impl in ("pallas", "xla"):
        x = [a.clone().requires_grad_() for a in inputs]
        outs = fc.fused_cgconv(x[0], batch.edges, x[1], x[2], x[3], x[4],
                               batch.neighbors,
                               batch.edge_mask.reshape(n, 12), tr, impl=impl)
        (outs[0] * ct).sum().backward()
        res.append(([o.detach() for o in outs], [a.grad for a in x]))
    (got, got_g), (want, want_g) = res
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5)
    for k, (a, b) in enumerate(zip(got_g, want_g)):
        if k == 2:
            # fc_full's bias: BN1 makes the loss invariant to it, so its
            # exact gradient is 0 and both impls return the roundoff of a
            # sum of ~10^5 dz terms, which the two orders do not share
            assert max(float(a.abs().max()), float(b.abs().max())) < 1e-3
            continue
        torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-4)


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
