"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version at shapes and inputs the CPU tests cannot reach (ragged
widths, G > F, rows that are all padding, NaN in masked slots), the
fixed-order reductions (kernels 2 and 4) bit-identical from run to run,
kernels 1 and 2 on a shared node pass, and the training op's kernel path
against its structured twin. Marked
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
    # the slot pass takes one thread a channel pair, at most 256 a row
    with pytest.raises(ValueError, match="256 threads per row"):
        fc.fused_cgconv_eval_cuda(*_args(dev, 8, 2, 264, 7))
    # past 44 columns, W_e [G, 2F] must fit one block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        fc.fused_cgconv_eval_cuda(*_args(dev, 8, 2, 256, 120))


@pytest.mark.parametrize("m", [1, 12])
@pytest.mark.parametrize("g", [1, 41, 60])
@pytest.mark.parametrize("f", [16, 64, 128])
def test_kernel_node_and_slot_passes(dev, f, g, m):
    """Kernel 1's node pass and slot pass over F, G (1 and 41 keep W_e in
    registers, 60 in shared memory) and M, at N = 1001 (not a multiple of
    a block's rows), with all-padding rows (-> 0) and NaN edges in masked
    slots: against the plain version, and the same bits when run again."""
    args = _args(dev, 1001, m, f, g)
    assert (g <= fc.W_E_REGISTER_MAX_G) == (g != 60)
    got = fc.fused_cgconv_eval_cuda(*args)
    again = fc.fused_cgconv_eval_cuda(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, fc.fused_cgconv_eval_reference(*args),
                               **TOL)
    assert (got[-3:] == 0).all()
    assert torch.equal(got, again)


def _close_on_scale(got, want, rtol=1e-4):
    """Column sums over up to ~10^5 slots, added in another order: held to
    rtol of the largest entry (a sum near 0 has no relative digits)."""
    assert torch.isfinite(got).all()
    scale = float(want.abs().max().clamp_min(1e-6))
    assert float((got - want).abs().max()) <= rtol * scale


@pytest.mark.parametrize("n,m,f,g", [
    (1784, 12, 64, 41), (4, 1, 64, 41), (37, 8, 16, 26), (100, 12, 32, 100),
    (129, 5, 96, 7), (7832, 12, 64, 41), (203, 7, 18, 41), (77, 12, 37, 3),
])
def test_stats_kernel_matches_plain_version(dev, n, m, f, g):
    """Kernel 2 (NaN edges in masked slots, trailing all-padding rows; F
    of 18 and 37 take the scalar P loads, 96 two column tiles): against
    its plain version, bit-identical when run again, and the same bits
    when handed the node pass's P, which matches its plain version."""
    nodes, edges, kernel, bias, _, _, nbr, mask, shift, _ = _args(
        dev, n, m, f, g)
    counts = [w.launches for w in (fc.fused_cgconv_stats_cuda,
                                   fc.fused_cgconv_node_cuda)]
    got = fc.fused_cgconv_stats_cuda(nodes, edges, kernel, bias, nbr, mask,
                                     shift)
    again = fc.fused_cgconv_stats_cuda(nodes, edges, kernel, bias, nbr, mask,
                                       shift)
    p = fc.fused_cgconv_node_cuda(nodes, kernel, bias)
    shared = fc.fused_cgconv_stats_cuda(nodes, edges, kernel, bias, nbr,
                                        mask, shift, p=p)
    torch.cuda.synchronize()
    # three stats calls; node passes: two inside, one alone
    assert [fc.fused_cgconv_stats_cuda.launches,
            fc.fused_cgconv_node_cuda.launches] == [counts[0] + 3,
                                                    counts[1] + 3]
    want = fc.fused_cgconv_stats_reference(nodes, edges, kernel, bias, nbr,
                                           mask, shift)
    assert torch.equal(got, again)
    assert torch.equal(got, shared)
    torch.testing.assert_close(
        p, fc.node_projections_reference(nodes, kernel, bias), **TOL)
    for row in range(2):
        _close_on_scale(got[row], want[row])


def test_stats_kernel_on_all_padding(dev):
    """Every slot padding (NaN edges everywhere): both sums are 0."""
    nodes, edges, kernel, bias, _, _, nbr, mask, shift, _ = _args(
        dev, 50, 12, 64, 41)
    mask.zero_()
    edges.fill_(float("nan"))
    got = fc.fused_cgconv_stats_cuda(nodes, edges, kernel, bias, nbr, mask,
                                     shift)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


def test_apply_pass_on_a_shared_p(dev):
    """Kernel 1 handed the node pass's P gives the bits it gives alone."""
    args = _args(dev, 1001, 12, 64, 41)
    p = fc.fused_cgconv_node_cuda(args[0], args[2], args[3])
    alone = fc.fused_cgconv_eval_cuda(*args)
    shared = fc.fused_cgconv_eval_cuda(*args, p=p)
    torch.cuda.synchronize()
    assert torch.equal(alone, shared)
    with pytest.raises(ValueError, match="p must be"):
        fc.fused_cgconv_eval_cuda(*args, p=p[:-1])


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
               (50, 12, 40), (7832, 12, 64), (301, 12, 18), (97, 7, 37)]


@pytest.mark.parametrize("n,m,f", _EPI_SHAPES)
def test_epilogue_kernels_match_plain_versions(dev, n, m, f):
    """Kernels 3, 4 and 5 (NaN z in masked slots, all-padding rows; F of
    18 and 37 take kernel 4's scalar path, M of 7 a partial slot chunk)
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
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    wrappers = (fc.fused_cgconv_node_cuda, fc.fused_cgconv_stats_cuda,
                fc.fused_cgconv_eval_cuda, fe.epilogue_reduce_cuda,
                fe.epilogue_dz_cuda)
    before = [w.launches for w in wrappers]
    res = []
    for impl in ("pallas", "xla"):
        x = [a.clone().requires_grad_() for a in inputs]
        outs = fc.fused_cgconv(x[0], batch.edges, x[1], x[2], x[3], x[4],
                               batch.neighbors,
                               batch.edge_mask.reshape(n, 12), tr, impl=impl)
        (outs[0] * ct).sum().backward()
        res.append(([o.detach() for o in outs], [a.grad for a in x]))
    # one forward and backward: one node pass feeds both slot passes
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1] * 5
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


def _raw_batch(dev, structures, s_cap, images, g_cap, m=12, radius=8.0):
    """(RawBatch on the card, RawSpec) for wire structures."""
    from cgnn_tpu_torch.data.featurize import GaussianDistance
    from cgnn_tpu_torch.data.rawbatch import RawSpec, RawStructure, pack_raw

    gdf = GaussianDistance(0.0, radius, 0.2)
    spec = RawSpec(snode_cap=s_cap, images=images, radius=radius, dense_m=m,
                   gauss_filter=gdf.filter, gauss_var=gdf.var)
    raws = [RawStructure.from_structure(s) for s in structures]
    rb = pack_raw(raws, g_cap, spec) if raws else pack_raw(
        [spec.template()], g_cap, spec)
    if not raws:  # an all-padding batch: clear the template's slot
        rb.atom_mask.zero_()
        rb.graph_mask.zero_()
        rb.lattices[0] = torch.eye(3)
    return rb.to(dev), spec


def _mp_structures(n, max_atoms, seed=0):
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset

    return [s for _, s, _ in synthetic_mp_dataset(4 * n, seed=seed)
            if s.num_atoms <= max_atoms][:n]


def _search_cases():
    from cgnn_tpu_torch.data.structure import Structure

    cubic = Structure(np.eye(3) * 3.0, [[0, 0, 0]], [29])
    return {
        # the flagship's top raw rung: 72 slots of 64 atoms, 125 images
        "top_rung": (lambda: _mp_structures(64, 64), 64, (2, 2, 2), 72, 12),
        # simple cubic: all first shells exact ties
        "exact_tie": (lambda: [cubic, cubic], 8, (3, 3, 3), 3, 12),
        # S not a multiple of 32 (nor of the 8 rows a block)
        "s_ragged": (lambda: _mp_structures(5, 37, seed=1), 37, (2, 2, 2),
                     6, 12),
        # K = 343 images, and M above 16 (the 32-entry lists)
        "k343_m20": (lambda: _mp_structures(4, 24, seed=2), 24, (3, 3, 3),
                     4, 20),
        "all_padding": (lambda: [], 16, (1, 1, 1), 4, 12),
    }


@pytest.mark.parametrize("case", sorted(_search_cases()))
def test_neighbor_search_kernel_matches_plain_version(dev, case):
    """Kernel 8 against its plain version: every output bit-equal (the
    same f32 operations in the same order, sqrt correctly rounded), and
    the same bits on a second run."""
    from cgnn_tpu_torch.ops import neighbor_search as ns

    make, s_cap, images, g_cap, m = _search_cases()[case]
    rb, spec = _raw_batch(dev, make(), s_cap, images, g_cap, m=m)
    offsets = ns.offsets_tensor(spec, dev)
    args = (rb.frac, rb.lattices, rb.atom_mask, offsets, spec.radius,
            spec.home_image, m)
    before = ns.neighbor_search_cuda.launches
    got = ns.neighbor_search_cuda(*args)
    again = ns.neighbor_search_cuda(*args)
    torch.cuda.synchronize()
    assert ns.neighbor_search_cuda.launches == before + 2
    want = ns.neighbor_search_reference(*args)
    for name, a, b, c in zip(("neighbors", "distances", "edge_mask",
                              "n_edges"), got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name
    nbr, dist, em, ne = got
    pad = rb.graph_mask == 0
    assert (em[pad] == 0).all() and (ne[pad] == 0).all()
    own = torch.arange(s_cap, device=dev, dtype=torch.int32)[None, :, None]
    assert torch.equal(nbr[pad], own.expand_as(nbr)[pad])
    if case == "all_padding":
        assert int(em.sum()) == 0
    else:
        assert int(ne.sum()) == int(em.sum()) > 0
    # the dispatcher routes a CUDA tensor to the kernel
    out = ns.neighbor_search(rb.frac, rb.lattices, rb.atom_mask, spec,
                             impl="pallas", offsets=offsets)
    assert ns.neighbor_search_cuda.launches == before + 3
    assert torch.equal(out[0], nbr) and not out[4].any()


def test_neighbor_search_kernel_refuses_what_it_does_not_take(dev):
    from cgnn_tpu_torch.ops import neighbor_search as ns

    rb, spec = _raw_batch(dev, _mp_structures(2, 16), 16, (1, 1, 1), 2)
    offsets = ns.offsets_tensor(spec, dev)
    base = [rb.frac, rb.lattices, rb.atom_mask, offsets, spec.radius,
            spec.home_image, 12]
    bad = list(base)
    bad[2] = rb.atom_mask.float()
    with pytest.raises(ValueError, match="amask must be torch.uint8"):
        ns.neighbor_search_cuda(*bad)
    bad = list(base)
    bad[6] = 33
    with pytest.raises(ValueError, match="max_num_nbr"):
        ns.neighbor_search_cuda(*bad)
    bad = list(base)
    bad[3] = offsets.cpu()
    with pytest.raises(ValueError, match="offsets is on cpu"):
        ns.neighbor_search_cuda(*bad)


def test_raw_server_runs_kernel_8(dev, tmp_path):
    """load_server(wire='raw') on the card launches kernel 8 once per raw
    flush, and answers as the plain search asked for by name
    (``raw_expander('xla')``) on the same staged batches."""
    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_dataset
    from cgnn_tpu_torch.ops import neighbor_search as ns
    from cgnn_tpu_torch.serve.server import load_server
    from cgnn_tpu_torch.train.step import make_predict_step

    cfg = ModelConfig(atom_fea_len=32, n_conv=2, dense_m=12,
                      cgconv_impl="pallas")
    dcfg = DataConfig()
    npz, meta = str(tmp_path / "params.npz"), str(tmp_path / "meta.json")
    convert.save_params(npz, meta, convert.init_params(cfg, dcfg, seed=1),
                        cfg, dcfg)
    calibration = load_synthetic(32, dcfg.featurize_config(), seed=3,
                                 keep_geometry=True)
    server, _ = load_server(npz, meta, batch_size=8, rungs=2,
                            calibration=calibration, device=dev, wire="raw",
                            log_fn=lambda *a: None)
    ss = server.shape_set
    wire = [r for r in (RawStructure.from_structure(s)
                        for _, s, _ in synthetic_dataset(12, seed=8))
            if ss.admits_raw(r)]
    assert len(wire) >= 8
    before = ns.neighbor_search_cuda.launches
    flushes = server.counts["pack_raw"]
    res = [server.predict(r, timeout_ms=60_000) for r in wire]
    assert all(r.wire == "raw" for r in res)
    assert (ns.neighbor_search_cuda.launches - before
            == server.counts["pack_raw"] - flushes > 0)
    assert server.drain(timeout_s=30)
    plain = make_predict_step(raw_expander=ss.raw_expander("xla", dev))
    before = ns.neighbor_search_cuda.launches
    want = np.stack([plain(server.state, ss.pack_raw([r]).to(dev))[0][0]
                     .cpu().numpy() for r in wire])
    assert ns.neighbor_search_cuda.launches == before
    np.testing.assert_allclose(np.stack([r.prediction for r in res]), want,
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# kernel 6, the sorted segment sum (the COO layout), and kernel 7, the
# windowed gather
# ---------------------------------------------------------------------------


def _segment_cases():
    rng = np.random.default_rng(1)
    n = 260  # empty nodes, a 700-edge hub, a tail node (tests/test_ops.py)
    hub = np.sort(np.concatenate([np.full(700, 5), rng.integers(100, 120, 50),
                                  np.full(30, n - 1)])).astype(np.int32)
    return {
        "hub_empty_tail": (rng.normal(size=(len(hub), 8)), hub, n),
        "f_ragged": (rng.normal(size=(333, 100)),
                     np.sort(rng.integers(0, 77, 333)).astype(np.int32), 77),
        "coo_batch": None,  # a packed COO batch, built in the test
    }


def _coo_batch_messages():
    """Messages over a real packed COO batch: padding edges (all on node
    N-1) zeroed, as CGConv's mask leaves them."""
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.graph import capacities_for, pack_graphs

    graphs = load_synthetic_mp(64, DataConfig().featurize_config(), seed=4)
    nc, ec = capacities_for(graphs, 64)
    b = pack_graphs(graphs, nc, ec, 72)
    rng = np.random.default_rng(2)
    msgs = rng.normal(size=(ec, 64)) * b.edge_mask.numpy()[:, None]
    return msgs, b.centers.numpy(), nc


@pytest.mark.parametrize("case", list(_segment_cases()))
def test_segment_sum_kernel_matches_plain_version(dev, case):
    """Kernel 6 against its plain version (rtol 1e-4 / atol 1e-5: the same
    f32 sums, in another order), bit-identical when run again; empty nodes
    give 0; the op routes a CUDA tensor to the kernel."""
    from cgnn_tpu_torch.ops import scatter

    msgs, centers, n = (_coo_batch_messages() if case == "coo_batch"
                        else _segment_cases()[case])
    m = torch.from_numpy(np.asarray(msgs, np.float32)).to(dev)
    c = torch.from_numpy(centers).to(dev)
    offsets = scatter.segment_offsets(c, n)
    before = scatter.segment_sum_sorted_cuda.launches
    got = scatter.segment_sum_sorted_cuda(m, offsets)
    again = scatter.segment_sum_sorted_cuda(m, offsets)
    torch.cuda.synchronize()
    assert scatter.segment_sum_sorted_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = scatter.segment_sum_sorted_reference(m, offsets)
    torch.testing.assert_close(got, want, **TOL)
    empty = np.setdiff1d(np.arange(n), centers)
    assert (got[torch.from_numpy(empty).to(dev)] == 0).all()
    out = scatter.segment_sum_sorted(m, c, n, impl="pallas")
    assert scatter.segment_sum_sorted_cuda.launches == before + 3
    assert torch.equal(out, got)


def _segment_layout(case, f):
    """Sorted centers over n nodes with a long node (more than
    ``long_range_rows(F)`` rows) where the case puts it."""
    from cgnn_tpu_torch.ops import scatter

    rng = np.random.default_rng(7)
    n = 300
    if case.startswith("hub"):
        hub = {"hub_first": 0, "hub_middle": n // 2, "hub_last": n - 1}[case]
        centers = np.concatenate([rng.integers(0, n, 2000),
                                  np.full(600, hub)])
    elif case == "one_node":  # every edge on node 17, the rest empty
        n, centers = 50, np.full(1000, 17)
    else:  # L-1, L, L+1 and 0 rows in turn: long nodes share blocks
        long_rows = scatter.long_range_rows(f)
        counts = np.tile([long_rows - 1, long_rows, long_rows + 1, 0], 40)
        n, centers = len(counts), np.repeat(np.arange(len(counts)), counts)
    return np.sort(centers).astype(np.int32), n


@pytest.mark.parametrize("case", ["hub_first", "hub_middle", "hub_last",
                                  "one_node", "ranges_around_L"])
@pytest.mark.parametrize("f", [1, 32, 33, 64, 100, 128, 256])
def test_segment_sum_kernel_long_ranges(dev, f, case):
    """Kernel 6 where a node's range is summed by its whole block (a hub
    at node 0, N/2 or N-1; every edge on one node; ranges of L-1, L and
    L+1 rows; empty nodes), over F: against its plain version (rtol 1e-4 /
    atol 1e-5), bit-identical when run again, 0 on empty nodes."""
    from cgnn_tpu_torch.ops import scatter

    centers, n = _segment_layout(case, f)
    rng = np.random.default_rng(f)
    m = torch.from_numpy(
        rng.normal(size=(len(centers), f)).astype(np.float32)).to(dev)
    offsets = scatter.segment_offsets(torch.from_numpy(centers).to(dev), n)
    got = scatter.segment_sum_sorted_cuda(m, offsets)
    again = scatter.segment_sum_sorted_cuda(m, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, scatter.segment_sum_sorted_reference(m, offsets), **TOL)
    empty = np.setdiff1d(np.arange(n), centers)
    assert (got[torch.from_numpy(empty).to(dev)] == 0).all()


def test_segment_sum_kernel_refuses_what_it_does_not_take(dev):
    from cgnn_tpu_torch.ops import scatter

    m = torch.randn(10, 8, device=dev)
    offsets = torch.tensor([0, 4, 10], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="messages must be torch.float32"):
        scatter.segment_sum_sorted_cuda(m.bfloat16(), offsets)
    with pytest.raises(ValueError, match="offsets must be torch.int32"):
        scatter.segment_sum_sorted_cuda(m, offsets.long())
    with pytest.raises(ValueError, match="contiguous"):
        scatter.segment_sum_sorted_cuda(torch.randn(10, 16, device=dev)[:, ::2],
                                        offsets)
    with pytest.raises(ValueError, match="outside the kernel"):
        scatter.segment_sum_sorted_cuda(torch.randn(10, 300, device=dev),
                                        offsets)


def _gather_cases():
    rng = np.random.default_rng(0)
    nodes = rng.normal(size=(512, 16)).astype(np.float32)
    return {
        "in_window": (nodes, np.repeat(np.arange(512), 5).astype(np.int32),
                      np.array([0, 0, 128, 256], np.int32), 256),
        "out_of_window": (nodes, rng.integers(0, 512, 512 * 3).astype(
            np.int32), np.array([0, 128, 256, 384], np.int32), 128),
        "clamped_last_block": (nodes, rng.integers(200, 512, 512 * 3).astype(
            np.int32), np.array([5, 130, 300, 470], np.int32), 256),
    }


@pytest.mark.parametrize("case", list(_gather_cases()))
def test_windowed_gather_kernel_matches_plain_version(dev, case):
    """Kernel 7 bit-equal to its plain version (out-of-window zeros
    included), and to index_select where every index is in its window."""
    from cgnn_tpu_torch.ops import windowed_gather as wg

    nodes, nbr, ws, window = (torch.from_numpy(a).to(dev) if isinstance(
        a, np.ndarray) else a for a in _gather_cases()[case])
    before = wg.windowed_gather_cuda.launches
    got = wg.windowed_gather_cuda(nodes, nbr, ws, window)
    torch.cuda.synchronize()
    assert wg.windowed_gather_cuda.launches == before + 1
    want = wg.windowed_gather_reference(nodes, nbr, ws, window)
    assert torch.equal(got, want)
    if case == "in_window":
        assert torch.equal(got.reshape(-1, nodes.shape[1]),
                           nodes.index_select(0, nbr))
    else:
        assert (got == 0).all(dim=-1).any()
    assert torch.equal(wg.windowed_gather(nodes, nbr, ws, window), got)
    with pytest.raises(ValueError, match="nodes must be torch.float32"):
        wg.windowed_gather_cuda(nodes.double(), nbr, ws, window)
