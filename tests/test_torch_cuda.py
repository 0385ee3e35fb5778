"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version at shapes and inputs the CPU tests cannot reach (ragged
widths, G > F, rows that are all padding, NaN in masked slots), the
fixed-order reductions (kernels 2 and 4) bit-identical from run to run,
kernels 1 and 2 on a shared node pass, the training op's kernel path
against its structured twin, a checkpoint of a card-resident state,
bulk raw inference's launches of kernel 8, bulk predict over two
entries on one card under both engines (each entry capturing on a side
stream of its own), two serving entries on one
card in every precision tier, the divergence guard inside a replayed
train graph, the COO gathers' fixed-order backward, two
data-parallel ranks sharing the card over gloo, two graph-sharded
ranks sharing it, the prefetch loader staging beside a capture, and the
epoch driver's background pair fetch (deferred and joined) bit-equal to
the synchronous one.
Marked ``cuda``; they skip where there is no card. On a GPU machine,
from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
need not have; this file imports none of it.)
"""

import dataclasses
import threading

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
               (50, 12, 40), (7832, 12, 64), (301, 12, 18), (97, 7, 37),
               # M of 1, 5 and 7 on the vector path: partial slot chunks
               (300, 1, 64), (200, 5, 64), (150, 7, 64), (61, 5, 20)]


@pytest.mark.parametrize("n,m,f", _EPI_SHAPES)
def test_epilogue_kernels_match_plain_versions(dev, n, m, f):
    """Kernels 3, 4 and 5 (NaN z in masked slots, all-padding rows; F of
    18 and 37 take the scalar paths, M of 1, 5 and 7 partial slot chunks)
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
    dense = Structure(np.eye(3) * 4.0,
                      np.random.default_rng(11).random((8, 3)),
                      [11, 17] * 4)
    return {
        # 8 atoms in a 4 Å cube: ~270 candidates within 8 Å a center, ~67
        # for each of its four warps, more than a warp's 64-key queue
        # holds: the queue flushes into the lane lists mid-search
        "queue_flush": (lambda: [dense], 8, (3, 3, 3), 2, 12),
        # simple cubic, M=8: 6 first-shell images, then 2 of the 12 tied
        # second-shell ones; the 12 reach the lane lists through the queue,
        # at most one to a lane a flush, so the tie at the M-th slot is
        # decided across lanes' lists
        "tie_m_slot": (lambda: [cubic], 8, (3, 3, 3), 2, 8),
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
    flush, counted on the card (each flush replays its rung's raw graph,
    captured at warm(), so the wrapper launches nothing), and answers as
    the plain search asked for by name (``raw_expander('xla')``) on the
    same staged batches."""
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
    res = []
    launched = _kernel_launches(
        lambda: res.extend(server.predict(r, timeout_ms=60_000)
                           for r in wire),
        {"search": "neighbor_search_kernel"})
    assert all(r.wire == "raw" for r in res)
    assert launched["search"] == server.counts["pack_raw"] - flushes > 0
    assert ns.neighbor_search_cuda.launches == before
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


# ---------------------------------------------------------------------------
# checkpoints of a card-resident state, and bulk raw inference
# ---------------------------------------------------------------------------


def _card_state(dev, optim="sgd"):
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.train.state import init_train_state

    cfg = ModelConfig(atom_fea_len=32, n_conv=2, dense_m=12,
                      cgconv_impl="pallas")
    dcfg = DataConfig()
    graphs = load_synthetic(48, dcfg.featurize_config(), seed=6)
    state, nc, ec = init_train_state(cfg, dcfg, graphs, batch_size=16,
                                     device=dev, optim=optim)
    return state, graphs, nc, ec


@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_checkpoint_of_card_state_restores_bit_equal(dev, tmp_path, optim):
    """A card-resident TrainState after a few kernel-path steps: saved,
    mutated on the card before the finalizer ran, and restored into a
    fresh card state, it equals the state at save time in every
    parameter, running statistic, optimizer buffer and count."""
    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.step import make_train_step

    state, graphs, nc, ec = _card_state(dev, optim)
    step = make_train_step()
    for b in batch_iterator(graphs, 16, nc, ec, dense_m=12, snug=True):
        step(state, b.to(dev))
    assert state.step >= 3
    want = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    opt_want = {id(p): {k: v.clone() for k, v in
                        state.optimizer.inner.state[p].items()}
                for p in state.optimizer.params}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, {"epoch": 0})
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(-1.0)
    restored, meta = mgr.restore(_card_state(dev, optim)[0])
    assert meta == {"epoch": 0} and restored.optimizer.count == state.step
    got = restored.model.state_dict()
    for k, v in want.items():
        assert got[k].device.type == "cuda" and torch.equal(got[k], v), k
    for p, q in zip(state.optimizer.params, restored.optimizer.params):
        for k, v in opt_want[id(p)].items():
            assert torch.equal(torch.as_tensor(
                restored.optimizer.inner.state[q][k]).to(v.device), v), k
    mgr.close()


def _kernel_launches(fn, symbols: dict) -> dict:
    """``fn()`` under the profiler -> {name: launches of the kernels whose
    name holds ``symbols[name]``}, counted on the card (a graph replay's
    kernels too)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(e.key, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {name: sum(c for k, c in events if sym in k)
            for name, sym in symbols.items()}


def test_raw_inference_launches_kernel_8_once_per_raw_batch(dev):
    """run_raw_inference on the card: kernel 8 once per raw batch, kernel
    1 n_conv times a batch, counted on the card; the answers those of the
    featurized path. A shape's first two batches step eagerly through
    the wrappers, its third is captured after a warm-up run, and its
    later ones replay the graph (train/graphs.py ``COUNTS``)."""
    import math

    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.data.rawbatch import plan_raw_spec, raw_from_graph
    from cgnn_tpu_torch.ops import neighbor_search as ns
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.graphs import COUNTS, reset_counts
    from cgnn_tpu_torch.train.infer import (
        run_fast_inference,
        run_raw_inference,
    )
    from cgnn_tpu_torch.train.step import InferenceState

    state, _, _, _ = _card_state(dev)
    fcfg = DataConfig().featurize_config()
    graphs = load_synthetic(70, fcfg, seed=9, keep_geometry=True)
    spec = plan_raw_spec(graphs, fcfg.gdf(), fcfg.radius, 12)
    ss = plan_shape_set(graphs, 16, rungs=2, dense_m=12, raw=spec)
    keep = [g for g in graphs if ss.admits_raw(raw_from_graph(g))]
    inf = InferenceState(state.model, state.normalizer)
    before = (ns.neighbor_search_cuda.launches,
              fc.fused_cgconv_eval_cuda.launches)
    reset_counts()
    out = []
    launched = _kernel_launches(
        lambda: out.append(run_raw_inference(
            inf, [raw_from_graph(g) for g in keep], ss)),
        {"search": "neighbor_search_kernel",
         "conv": "fused_cgconv_eval_slot"})
    got, rate = out[0]
    batches = math.ceil(len(keep) / ss.largest.graph_cap)
    warm = COUNTS["predict_raw_warm_runs"]
    eager = COUNTS["predict_raw_runs"] - COUNTS["predict_raw_replays"] + warm
    assert batches >= 3 and rate > 0
    assert COUNTS["predict_raw_runs"] == batches
    assert COUNTS["predict_raw_captures"] >= 1
    assert warm == COUNTS["predict_raw_captures"]  # one warm-up run each
    assert launched == {"search": batches + warm,
                        "conv": 2 * (batches + warm)}
    assert ns.neighbor_search_cuda.launches - before[0] == eager
    assert fc.fused_cgconv_eval_cuda.launches - before[1] == 2 * eager
    want, _ = run_fast_inference(inf, keep, 16, shape_set=ss)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("workers", [0, 2])
def test_compact_inference_recycles_pinned_buffers_safely(dev, workers):
    """Bulk compact predict on the card over many more batches than the
    pool holds buffers: each pinned buffer is reused only after the event
    recorded behind its asynchronous copy has completed, so the answers
    equal the full-staged ones (a buffer recycled under an in-flight copy
    would hand the step another batch's bytes)."""
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.compact import CompactSpec
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.infer import run_fast_inference
    from cgnn_tpu_torch.train.step import InferenceState

    state, _, _, _ = _card_state(dev)
    inf = InferenceState(state.model, state.normalizer)
    fcfg = DataConfig().featurize_config()
    graphs = load_synthetic(400, fcfg, seed=12)
    spec = CompactSpec.build(graphs, fcfg.gdf(), dense_m=12)
    full_ss = plan_shape_set(graphs, 4, rungs=2, dense_m=12)
    comp_ss = plan_shape_set(graphs, 4, rungs=2, dense_m=12, compact=spec)
    want, _ = run_fast_inference(inf, graphs, 4, shape_set=full_ss)
    stats = {}
    got, _ = run_fast_inference(inf, graphs, 4, shape_set=comp_ss,
                                pack_workers=workers, stats=stats)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert stats["buffers_reused"] > 5 * stats["buffers_allocated"] > 0
    # the buffers are page-locked: the copies to the card are asynchronous
    buf = comp_ss.buffer_factory(comp_ss.largest, pin=True)()
    assert all(t.is_pinned() for t in buf.tensors())


def test_loader_side_stream_batches_equal_synchronous_copies(dev):
    """prefetch_to_device on the card: batches copied on a side stream and
    handed over through an event equal the synchronous ``.to`` copies bit
    for bit, and a step reading them gives the same metrics; a device
    named without an index is the caller's current one."""
    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.data.loader import LoaderStats, prefetch_to_device
    from cgnn_tpu_torch.train.step import make_eval_step

    state, graphs, nc, ec = _card_state(dev)
    host = list(batch_iterator(graphs, 16, nc, ec, dense_m=12, snug=True))
    stats = LoaderStats()
    staged = list(prefetch_to_device(iter(host), dev, size=2, stats=stats))
    assert len(staged) == len(host) == stats.batches >= 3
    step = make_eval_step()
    for got, h in zip(staged, host):
        want = h.to(dev)
        for name in ("nodes", "edges", "neighbors", "edge_mask", "targets",
                     "in_slots", "over_slots"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.device.type == "cuda" and torch.equal(a, b), name
        # an op PyTorch runs in no fixed order may move the last ulp of a
        # step repeated on the same bits (the pooling's sums are fixed)
        ma, mb = step(state, got), step(state, want)
        for k in mb:
            torch.testing.assert_close(ma[k], mb[k], rtol=1e-6, atol=0)
    again = list(prefetch_to_device(iter(host[:2]), "cuda", size=1))
    assert all(b.nodes.device == dev for b in again)


@dataclasses.dataclass
class _Staged:
    a: torch.Tensor

    def to(self, device, non_blocking=False):
        return _Staged(self.a.to(device, non_blocking=non_blocking))


def test_loader_stages_beside_a_capture_on_every_pool_turn(dev):
    """The loader's side stream is never the capture stream: the stream
    pools hand out 32 streams in turn, and a side stream from the capture
    stream's pool was that stream every 32nd loader. Over 33 loaders, each
    stages a batch while the consumer captures a step on
    ``capture_stream``; every batch arrives whole and the graph replays."""
    from cgnn_tpu_torch.data.loader import prefetch_to_device, staging_stream
    from cgnn_tpu_torch.train.graphs import capture_stream

    cap = capture_stream(dev)
    assert all(staging_stream(dev).cuda_stream != cap.cuda_stream
               for _ in range(64))
    x = torch.arange(8.0, device=dev)
    for turn in range(33):
        host = [_Staged((torch.arange(4096.0) + 10 * turn + i).pin_memory())
                for i in range(3)]
        capturing, staged = threading.Event(), threading.Event()

        def batches():
            yield host[0]
            assert capturing.wait(30)
            yield host[1]  # staged while the consumer captures
            staged.set()
            yield host[2]

        got = []
        for i, b in enumerate(prefetch_to_device(batches(), dev, size=2)):
            got.append(b.a.clone())
            if i == 0:
                g = torch.cuda.CUDAGraph()
                cap.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(cap):
                    g.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = x * 2
                        capturing.set()
                        assert staged.wait(30)
                    finally:
                        g.capture_end()
                torch.cuda.current_stream(dev).wait_stream(cap)
                g.replay()
                assert torch.equal(out, torch.arange(8.0, device=dev) * 2)
        assert [torch.equal(a.cpu(), h.a) for a, h in zip(got, host)] == [
            True] * 3, turn


# ---------------------------------------------------------------------------
# step graphs (train/graphs.py): replay against eager, capture failures,
# and the server's captures after warm-up
# ---------------------------------------------------------------------------

GRAPH_TOL = dict(rtol=1e-5, atol=1e-6)  # without deterministic algorithms


def _state_tensors(state):
    out = {f"model/{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.optimizer.params):
        for k, v in state.optimizer.inner.state[p].items():
            out[f"opt/{i}/{k}"] = v.clone()
    return out


def _replay_vs_eager(dev, optim):
    """Four train steps eagerly on one state and as replays of a train
    StepGraph on another -> (eager state, replayed state, graph, the
    eager sums, the graph's sums, kernel 2's launches: by its wrapper in
    the capture's warm-up runs and in the replays, and on the card in
    the replays)."""
    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.graphs import StepGraph, state_guard
    from cgnn_tpu_torch.train.metrics import DeviceSums, fetch_device_sums
    from cgnn_tpu_torch.train.step import make_train_step

    eager, graphs, nc, ec = _card_state(dev, optim)
    replayed = _card_state(dev, optim)[0]
    batches = [b.to(dev) for b in batch_iterator(graphs, 16, nc, ec,
                                                 dense_m=12, snug=True)]
    batches = (batches * 4)[:4]
    step, sums = make_train_step(), DeviceSums()
    for b in batches:
        sums.add(step(eager, b))
    before = _state_tensors(replayed)
    gsums = DeviceSums()
    wrapper = fc.fused_cgconv_stats_cuda
    at_start = wrapper.launches
    g = StepGraph(lambda b: gsums.add(step(replayed, b)), batches[0],
                  device=dev, kind="train",
                  guard=state_guard(replayed, sums=[gsums]),
                  on_replay=lambda: replayed.optimizer.advance(1))
    after_capture = _state_tensors(replayed)
    for k, v in before.items():  # the capture left the state as it was
        assert torch.equal(after_capture[k], v), k
    gsums.zero()
    at_replays = wrapper.launches

    def replay():
        for b in batches:
            g.run(b)

    card = _kernel_launches(replay, {"stats": "fused_cgconv_stats_slot"})
    launched = {"warm_up": at_replays - at_start,
                "replays": wrapper.launches - at_replays,
                "card": card["stats"]}
    return (eager, replayed, g, fetch_device_sums(sums.sums),
            fetch_device_sums(gsums.sums), launched)


def _diffs(a, b) -> dict:
    return {k: float((a[k].double() - v.double()).abs().max())
            for k, v in b.items() if not torch.equal(a[k], v)}


@pytest.mark.parametrize("optim", ["sgd", "adam"])
@pytest.mark.parametrize("deterministic", [True, False])
def test_train_step_graph_replays_equal_eager(dev, optim, deterministic):
    """A train StepGraph replayed over 4 batches against the same steps
    run eagerly: its capture leaves the state untouched, each replay
    launches kernel 2 n_conv = 2 times on the card, through no wrapper
    (the wrapper counted the two warm-up runs' launches alone), the host
    count follows the device count. Under PyTorch's deterministic
    algorithms every parameter, running stat and optimizer buffer is
    bit-equal; without them (the pooling's sums are fixed-order, but
    PyTorch may order another op freely) SGD's parameters and running
    stats stay within GRAPH_TOL (its
    momentum buffers hold near-zero sums of noisy gradients; Adam turns
    the rounding noise
    on fc_full's bias, whose true gradient is zero under BatchNorm, into
    +-lr by its sign, so only its metric sums are compared)."""
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        eager, replayed, g, want, got, launched = _replay_vs_eager(dev,
                                                                   optim)
    finally:
        torch.use_deterministic_algorithms(False)
    assert launched == {"warm_up": 2 * 2, "replays": 0, "card": 2 * 4}
    assert replayed.optimizer.count == eager.optimizer.count == 4
    assert int(replayed.optimizer._count_t) == 4
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    diffs = _diffs(_state_tensors(replayed), _state_tensors(eager))
    if deterministic:
        assert not diffs, diffs
    elif optim == "sgd":  # every parameter and running stat
        ew, gw = _state_tensors(eager), _state_tensors(replayed)
        for k, v in ew.items():
            if k.startswith("model/"):
                torch.testing.assert_close(gw[k], v, **GRAPH_TOL,
                                           msg=f"{k}: {diffs}")


def test_eval_step_graph_replays_equal_eager(dev):
    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.graphs import StepGraph
    from cgnn_tpu_torch.train.metrics import DeviceSums, fetch_device_sums
    from cgnn_tpu_torch.train.step import make_eval_step

    state, graphs, nc, ec = _card_state(dev)
    batches = [b.to(dev) for b in batch_iterator(graphs, 16, nc, ec,
                                                 dense_m=12, in_cap=0,
                                                 snug=True)]
    esums, estep = DeviceSums(), make_eval_step()
    eg = StepGraph(lambda b: esums.add(estep(state, b)), batches[0],
                   device=dev, kind="eval")
    for b in batches:
        esums.zero()
        eg.run(b)
        got = fetch_device_sums(esums.sums)
        want = make_eval_step()(state, b)
        for k, v in want.items():
            assert got[k] == pytest.approx(float(v), rel=1e-5), k


def test_capture_blocker_raises_without_eager_fallback(dev):
    """A step that reads the device back (``.item()``) runs in warm-up
    but cannot be captured: the StepGraph raises, and nothing runs it
    eagerly instead."""
    from cgnn_tpu_torch.train.graphs import GraphCaptureError, StepGraph

    x = torch.ones(8, device=dev)
    calls = []

    def body():
        calls.append(1)
        return x * float(x.sum().item())

    with pytest.raises(GraphCaptureError, match="capture failed"):
        StepGraph(body, device=dev)  # a predict step: one warm-up run
    assert len(calls) == 2  # one warm-up run, one capture attempt


def test_failed_capture_restores_the_state(dev):
    """A train step that cannot be captured leaves the state as its
    guard found it: the warm-up runs' updates are copied back before
    the error is raised."""
    from cgnn_tpu_torch.train.graphs import (
        GraphCaptureError,
        StepGraph,
        tensor_guard,
    )

    w = torch.zeros(4, device=dev)

    def body():
        w.add_(1.0)
        return w * float(w.sum().item())

    with pytest.raises(GraphCaptureError):
        StepGraph(body, device=dev, kind="train",
                  guard=tensor_guard(lambda: [w]))
    assert torch.equal(w, torch.zeros(4, device=dev))


def test_predict_graph_defers_its_capture_to_the_third_batch(dev):
    """``eager_runs=2`` (bulk predict's): the first two batches step
    eagerly (no capture), the third captures after its warm-up run, and
    every answer equals the eager step's on its own batch."""
    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.graphs import COUNTS, StepGraph, reset_counts
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    state, graphs, nc, ec = _card_state(dev)
    state.model.eval()
    inf, step = InferenceState(state.model, state.normalizer), \
        make_predict_step()
    host = list(batch_iterator(graphs, 16, nc, ec, dense_m=12, in_cap=0,
                               snug=True))
    reset_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g = StepGraph(lambda b: step(inf, b), host[0], device=dev,
                      eager_runs=2)
        assert g.graph is None
        got = [g.run(b).clone() for b in host[:2]]
        assert g.graph is None and COUNTS["predict_captures"] == 0
        for b in host[2:]:
            got.append(g.run(b).clone())
        want = [step(inf, b.to(dev)) for b in host]
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(host) >= 3
    assert g.graph is not None and g.replays == len(host) - 2
    assert COUNTS["predict_captures"] == 1
    assert COUNTS["predict_warm_runs"] == 1
    for out, w in zip(got, want):
        assert torch.equal(out, w)


def test_server_captures_nothing_after_warm_over_a_mixed_burst(dev,
                                                               tmp_path):
    """load_server(wire='raw', compact='on') captures every rung's full,
    compact and raw predict graphs at warm(); a burst over every rung and
    both wires then replays them and captures nothing more."""
    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_dataset
    from cgnn_tpu_torch.serve.server import load_server

    cfg = ModelConfig(atom_fea_len=32, n_conv=2, dense_m=12,
                      cgconv_impl="pallas")
    dcfg = DataConfig()
    npz, meta = str(tmp_path / "params.npz"), str(tmp_path / "meta.json")
    convert.save_params(npz, meta, convert.init_params(cfg, dcfg, seed=1),
                        cfg, dcfg)
    calibration = load_synthetic(64, dcfg.featurize_config(), seed=3,
                                 keep_geometry=True)
    server, _ = load_server(npz, meta, batch_size=16, rungs=3,
                            calibration=calibration, device=dev, wire="raw",
                            compact="on", log_fn=lambda *a: None)
    st = server.stats()["counts"]
    assert st["graph_captures"] == 9 and st["captures_after_warm"] == 0
    wire = [RawStructure.from_structure(s)
            for _, s, _ in synthetic_dataset(24, seed=8)]
    futs = []
    for size in (1, 3, 17, 5, 40, 2):  # every rung, both wires
        futs += [server.submit(g, timeout_ms=60_000)
                 for g in calibration[:size]]
        futs += [server.submit(r, timeout_ms=60_000)
                 for r in wire[:size // 2]]
        for f in futs:
            f.result(timeout=120)
    assert server.drain(timeout_s=30)
    st = server.stats()["counts"]
    assert st["captures_after_warm"] == 0 and st["batch_failures"] == 0
    assert st["graph_replays"] == st["batches"] + 9 > 9


def test_entries_capture_on_side_streams_of_their_own(dev):
    """Graphs that replay on different streams capture on different side
    streams, and graphs that replay on one stream on one: cuBLAS bakes
    the capture stream's workspace into a graph, so two entries that
    replay at once must not share it (shared, the replays raced on it
    and hung the card)."""
    from cgnn_tpu_torch.serve.devices import entry_streams
    from cgnn_tpu_torch.train.graphs import capture_stream

    a, b = entry_streams([dev, dev])
    assert capture_stream(dev, a) is capture_stream(dev, a)
    assert capture_stream(dev, a) != capture_stream(dev, b)
    assert capture_stream(dev) not in (capture_stream(dev, a),
                                       capture_stream(dev, b))


@pytest.mark.parametrize("wire", ["full", "compact", "raw"])
@pytest.mark.parametrize("engine", ["mesh", "threads"])
def test_bulk_predict_over_two_entries_on_one_card(dev, engine, wire):
    """Bulk predict over [cuda:0, cuda:0] under both engines, over more
    than one fetch window and a partial last one: every entry replays
    its captured graphs, and the answers are bit-equal to one entry's on
    the same packed batches (the mesh engine's last window is fetched on
    the stream that restacked it; a threads entry's pooled buffers go
    back behind its own fence)."""
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.compact import CompactSpec
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.data.rawbatch import plan_raw_spec, raw_from_graph
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train import infer
    from cgnn_tpu_torch.train.step import InferenceState

    state, _, _, _ = _card_state(dev)
    inf = InferenceState(state.model, state.normalizer)
    fcfg = DataConfig().featurize_config()
    graphs = load_synthetic(300, fcfg, seed=13, keep_geometry=True)
    kw = {}
    if wire == "compact":
        kw["compact"] = CompactSpec.build(graphs, fcfg.gdf(), dense_m=12)
    if wire == "raw":
        kw["raw"] = plan_raw_spec(graphs, fcfg.gdf(), fcfg.radius, 12)
    ss = plan_shape_set(graphs, 4, rungs=2, dense_m=12, **kw)
    if wire == "raw":
        items = [r for r in map(raw_from_graph, graphs) if ss.admits_raw(r)]

        def count(xs):
            return -(-len(xs) // ss.largest.graph_cap)

        def run(xs, **k):
            return infer.run_raw_inference(inf, xs, ss, **k)
    else:
        items = graphs

        def count(xs):
            return len(list(infer._shape_set_plan(xs, ss)))

        def run(xs, **k):
            return infer.run_fast_inference(inf, xs, 4, shape_set=ss, **k)
    while count(items) % infer._WINDOW == 0:  # a partial last window
        items = items[:-1]
    one, _ = run(items)
    stats = {}
    got, _ = run(items, devices=[dev, dev], engine=engine, stats=stats)
    assert stats["engine"] == engine
    assert stats["batches"] > infer._WINDOW, stats
    assert all(r > 0 for r in stats["entry_replays"]), stats
    assert np.array_equal(got, one)


@pytest.mark.parametrize("engine", ["mesh", "threads"])
def test_two_entries_on_one_card_serve_every_tier(dev, tmp_path, engine):
    """load_server over [cuda:0, cuda:0] warming f32, bf16 and int8
    captures each rung's full, compact and raw graphs a tier and an
    entry; a mixed-tier burst captures nothing more; one request a flush
    answers bit-equal to a one-entry server in every tier."""
    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.serve.server import load_server

    cfg = ModelConfig(atom_fea_len=32, n_conv=2, dense_m=12,
                      cgconv_impl="pallas")
    dcfg = DataConfig()
    npz, meta = str(tmp_path / "params.npz"), str(tmp_path / "meta.json")
    convert.save_params(npz, meta, convert.init_params(cfg, dcfg, seed=1),
                        cfg, dcfg)
    calibration = load_synthetic(64, dcfg.featurize_config(), seed=3,
                                 keep_geometry=True)
    kw = dict(batch_size=16, rungs=3, calibration=calibration, device=dev,
              wire="raw", compact="on", cache_size=0,
              precision="f32,bf16,int8", log_fn=lambda *a: None)
    one, _ = load_server(npz, meta, **kw)
    two, _ = load_server(npz, meta, devices=[dev, dev], engine=engine, **kw)
    try:
        assert two.engine == engine
        st = two.stats()["counts"]
        assert st["graph_captures"] == 3 * 3 * 3 * 2
        tiers = ("f32", "bf16", "int8")
        for k, g in enumerate(calibration[:12]):
            t = tiers[k % 3]
            a = two.predict(g, timeout_ms=60_000, precision=t)
            b = one.predict(g, timeout_ms=60_000, precision=t)
            assert a.precision == b.precision == t
            assert np.array_equal(a.prediction, b.prediction), (t, k)
        # a tier at a time: flushes of many requests, every shard real
        futs = [two.submit(g, timeout_ms=60_000, precision=t)
                for t in tiers for g in calibration]
        for f in futs:
            f.result(timeout=120)
        st = two.stats()
        assert st["counts"]["captures_after_warm"] == 0
        assert all(d["dispatches"] >= 1 for d in st["devices"])
    finally:
        assert one.drain(timeout_s=30) and two.drain(timeout_s=30)


# ---------------------------------------------------------------------------
# the divergence guard inside a replayed graph; COO's fixed-order gather
# ---------------------------------------------------------------------------


def test_guarded_train_graph_skips_a_nan_batch_in_replay(dev):
    """A guarded train StepGraph replayed over four batches, the second
    NaN (``faultinject.poison_nan``), against the same guarded steps run
    eagerly on the three clean ones, under deterministic algorithms:
    every tensor bit-equal, the device count 3 and the host count
    settled to it, one capture, the skip reported only for the NaN
    batch."""
    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.resilience.faultinject import poison_nan
    from cgnn_tpu_torch.resilience.guard import guard_step
    from cgnn_tpu_torch.train.graphs import StepGraph, state_guard
    from cgnn_tpu_torch.train.loop import settle_count
    from cgnn_tpu_torch.train.metrics import (
        DeviceSums,
        fetch_device_sums,
        means_from_sums,
    )
    from cgnn_tpu_torch.train.step import make_train_step

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, graphs, nc, ec = _card_state(dev)
        replayed = _card_state(dev)[0]
        clean = [b.to(dev) for b in batch_iterator(graphs, 16, nc, ec,
                                                   dense_m=12, snug=True)]
        clean = (clean * 3)[:3]
        step = guard_step(make_train_step())
        for b in clean:
            step(eager, b)
        sums = DeviceSums()
        g = StepGraph(lambda b: sums.add(step(replayed, b)), clean[0],
                      device=dev, kind="train",
                      guard=state_guard(replayed, sums=[sums]),
                      on_replay=lambda: replayed.optimizer.advance(1))
        skips = []
        for b in [clean[0], poison_nan(clean[1]), clean[1], clean[2]]:
            sums.zero()
            g.run(b)
            m = means_from_sums(fetch_device_sums(sums.sums), 1)
            settle_count(replayed, m)
            skips.append(round(m["guard_skipped"]))
    finally:
        torch.use_deterministic_algorithms(False)
    assert skips == [0, 1, 0, 0] and g.graph is not None
    assert int(replayed.optimizer._count_t) == replayed.optimizer.count \
        == eager.optimizer.count == 3
    diffs = _diffs(_state_tensors(replayed), _state_tensors(eager))
    assert not diffs, diffs


def test_coo_gather_backward_is_fixed_order_on_the_card(dev):
    """``gather_fixed_order``'s backward through kernel 6 ('pallas') and
    through ``segment_reduce`` ('xla') on a packed COO batch's neighbors
    and centers: each bit-equal run to run, within TOL of the other and
    of ``index_select``'s ``index_add_`` gradient."""
    from cgnn_tpu_torch.data.graph import csr_transpose
    from cgnn_tpu_torch.ops.segment import gather_fixed_order

    _, centers, n = _coo_batch_messages()
    centers = centers.astype(np.int32)
    rng = np.random.default_rng(3)
    e = centers.size
    neighbors = rng.integers(0, n, e).astype(np.int32)
    orders = {}
    for name, idx, sorted_ in (("centers", centers, True),
                               ("neighbors", neighbors, False)):
        order, offsets = csr_transpose(idx, n, sorted_)
        orders[name] = (None if order is None
                        else torch.from_numpy(order).to(dev),
                        torch.from_numpy(offsets).to(dev))
    centers = torch.from_numpy(centers).to(dev)
    neighbors = torch.from_numpy(neighbors).to(dev)
    values = torch.from_numpy(rng.standard_normal((n, 64)).astype(
        np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((e, 64)).astype(
        np.float32)).to(dev)

    def grad(idx, name, impl):
        x = values.clone().requires_grad_()
        out = gather_fixed_order(x, idx, *orders[name], impl)
        (out * ct).sum().backward()
        return x.grad

    for idx, name in ((centers, "centers"), (neighbors, "neighbors")):
        y = values.clone().requires_grad_()
        (y.index_select(0, idx) * ct).sum().backward()
        for impl in ("pallas", "xla"):
            first = grad(idx, name, impl)
            assert torch.equal(grad(idx, name, impl), first), impl
            torch.testing.assert_close(first, y.grad, **TOL)


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_pinned_pack_is_page_locked_and_bit_equal(dev, layout):
    """``pack_graphs(pin=True)``, what the prefetch loader copies from on
    a card: every tensor page-locked and bit-equal to the pageable pack,
    on the host and after an asynchronous copy to the card."""
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.graph import (
        capacities_for,
        overflow_cap,
        pack_graphs,
    )

    graphs = load_synthetic_mp(64, DataConfig().featurize_config(), seed=4)
    dense_m = 12 if layout == "dense" else None
    nc, ec = capacities_for(graphs, 64, dense_m=dense_m)
    kw = ({"over_cap": overflow_cap(graphs, 72, 12)} if dense_m
          else {"coo_transpose": True})
    want = pack_graphs(graphs, nc, ec, 72, dense_m=dense_m, **kw)
    got = pack_graphs(graphs, nc, ec, 72, dense_m=dense_m, pin=True, **kw)
    staged = got.to(dev, non_blocking=True)
    torch.cuda.synchronize(dev)
    for name, w in want.numpy().items():
        g = getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            assert g.is_pinned(), name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
            np.testing.assert_array_equal(
                getattr(staged, name).cpu().numpy(), w, err_msg=name)


# ---------------------------------------------------------------------------
# the bf16 instances of kernels 1, 2, 4 and 5
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


@pytest.mark.parametrize("n,m,f,g", [
    (1784, 12, 64, 41),  # the flagship's top serving rung
    (37, 8, 16, 26),  # the CPU tests' widths
    (100, 12, 32, 100),  # G > 44: the slot pass keeps W_e in shared memory
    (129, 5, 96, 7),  # F not a power of two
])
def test_bf16_conv_instances_match(dev, n, m, f, g):
    """Kernels 1 and 2 on bf16 nodes and edges: the f32 instances' bits on
    the widened inputs (the same arithmetic in the same order), and their
    plain version (the f32 one on the widened inputs) within TOL; counted
    by the bf16 wrappers alone; a mix of storage types refused."""
    args = list(_args(dev, n, m, f, g))
    args[0], args[1] = args[0].to(BF16), args[1].to(BF16)
    wide = [args[0].float(), args[1].float(), *args[2:]]
    counts = [w.launches for w in (fc.fused_cgconv_node_bf16_cuda,
                                   fc.fused_cgconv_eval_bf16_cuda,
                                   fc.fused_cgconv_stats_bf16_cuda)]
    got = fc.fused_cgconv_eval_bf16_cuda(*args)
    shift = args[8]
    sargs = (*args[:4], args[6], args[7], shift)
    stats = fc.fused_cgconv_stats_bf16_cuda(*sargs)
    p = fc.fused_cgconv_node_bf16_cuda(args[0], args[2], args[3])
    torch.cuda.synchronize()
    assert [fc.fused_cgconv_node_bf16_cuda.launches,
            fc.fused_cgconv_eval_bf16_cuda.launches,
            fc.fused_cgconv_stats_bf16_cuda.launches] == [
                counts[0] + 3, counts[1] + 1, counts[2] + 1]
    assert torch.equal(got, fc.fused_cgconv_eval_cuda(*wide))
    torch.testing.assert_close(got, fc.fused_cgconv_eval_reference(*args),
                               **TOL)
    wsargs = (*wide[:4], wide[6], wide[7], shift)
    assert torch.equal(stats, fc.fused_cgconv_stats_cuda(*wsargs))
    want = fc.fused_cgconv_stats_reference(*sargs)
    for row in range(2):
        _close_on_scale(stats[row], want[row])
    assert torch.equal(p, fc.fused_cgconv_node_cuda(wide[0], wide[2],
                                                    wide[3]))
    with pytest.raises(ValueError, match="edges must be torch.bfloat16"):
        fc.fused_cgconv_eval_bf16_cuda(args[0], wide[1], *args[2:])
    with pytest.raises(ValueError, match="nodes must be torch.float32"):
        fc.fused_cgconv_eval_cuda(*args)


@pytest.mark.parametrize("n,m,f", [(7832, 12, 64), (37, 8, 16),
                                   (129, 5, 96), (301, 12, 18),
                                   # F % 8 = 4: kernel 5's scalar path
                                   (50, 12, 20),
                                   (300, 1, 64), (200, 5, 64), (150, 7, 64)])
def test_bf16_epilogue_instances_match(dev, n, m, f):
    """Kernels 4 and 5 on bf16 z: the f32 instances' bits on the widened
    z (dz rounded to bf16), their plain versions within the f32
    tolerances; F = 18 takes kernel 4's scalar path, F = 18 and 20 kernel
    5's."""
    fe, z, mask, cst, ct, red5 = _epilogue_args(dev, n, m, f)
    zb = z.to(BF16)
    counts = [fe.epilogue_reduce_bf16_cuda.launches,
              fe.epilogue_dz_bf16_cuda.launches]
    red = fe.epilogue_reduce_bf16_cuda(zb, mask, cst, ct)
    dz = fe.epilogue_dz_bf16_cuda(zb, mask, cst, red5, ct)
    torch.cuda.synchronize()
    assert [fe.epilogue_reduce_bf16_cuda.launches,
            fe.epilogue_dz_bf16_cuda.launches] == [counts[0] + 1,
                                                    counts[1] + 1]
    assert dz.dtype == BF16
    assert torch.equal(red, fe.epilogue_reduce_cuda(zb.float(), mask, cst,
                                                    ct))
    assert torch.equal(dz, fe.epilogue_dz_cuda(zb.float(), mask, cst, red5,
                                               ct).to(BF16))
    want = fe.epilogue_reduce_reference(zb, mask, cst, ct)
    for row in range(4):
        _close_on_scale(red[row], want[row], rtol=5e-4)
    torch.testing.assert_close(
        dz, fe.epilogue_dz_reference(zb, mask, cst, red5, ct),
        rtol=2 ** -7, atol=1e-5)
    assert (dz[mask == 0] == 0).all()


def test_bf16_training_op_runs_only_bf16_instances(dev):
    """fused_cgconv on bf16 nodes and edges on the card: one bf16 node,
    stats and apply pass and one bf16 kernel 4 and 5, no f32 instance;
    values and gradients within 2e-2 of the f32 kernel path's on the
    widened inputs (bf16 z in the backward)."""
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    graphs = load_synthetic_mp(48, seed=5)
    nc, ec = capacities_for(graphs, 48, dense_m=12)
    batch = next(iter(batch_iterator(graphs, 48, nc, ec, dense_m=12,
                                     snug=True))).to(dev)
    n = batch.nodes.shape[0]
    f, g = 64, batch.edges.shape[-1]
    rng = np.random.default_rng(2)

    def leaf(shape, s=1.0):
        return torch.tensor(s * rng.standard_normal(shape),
                            dtype=torch.float32, device=dev)

    inputs = [leaf((n, f)).to(BF16),
              leaf((2 * f + g, 2 * f), (2 * f + g) ** -0.5),
              leaf(2 * f, 0.1), 1.0 + leaf(2 * f, 0.1), leaf(2 * f, 0.2)]
    ct = leaf((n, f))
    tr = (batch.in_slots, batch.in_mask, batch.over_slots, batch.over_nodes,
          batch.over_mask)
    wrappers = {"f32": (fc.fused_cgconv_node_cuda, fc.fused_cgconv_stats_cuda,
                        fc.fused_cgconv_eval_cuda, fe.epilogue_reduce_cuda,
                        fe.epilogue_dz_cuda),
                "bf16": (fc.fused_cgconv_node_bf16_cuda,
                         fc.fused_cgconv_stats_bf16_cuda,
                         fc.fused_cgconv_eval_bf16_cuda,
                         fe.epilogue_reduce_bf16_cuda,
                         fe.epilogue_dz_bf16_cuda)}
    res = []
    for kind in ("bf16", "f32"):
        before = {k: [w.launches for w in ws] for k, ws in wrappers.items()}
        x = [a.clone().requires_grad_() if kind == "bf16"
             else a.float().clone().requires_grad_() for a in inputs]
        edges = batch.edges.to(BF16) if kind == "bf16" \
            else batch.edges.to(BF16).float()
        outs = fc.fused_cgconv(x[0], edges, x[1], x[2], x[3], x[4],
                               batch.neighbors,
                               batch.edge_mask.reshape(n, 12), tr,
                               impl="pallas",
                               dtype=BF16 if kind == "bf16"
                               else torch.float32)
        (outs[0] * ct).sum().backward()
        ran = {k: [w.launches - b for w, b in zip(ws, before[k])]
               for k, ws in wrappers.items()}
        other = "f32" if kind == "bf16" else "bf16"
        assert ran == {kind: [1] * 5, other: [0] * 5}, ran
        res.append(([o.detach().float() for o in outs[:3]],
                    [a.grad.float() for a in x]))
    (got, got_g), (want, want_g) = res
    for k, (a, b) in enumerate(zip(got + got_g, want + want_g)):
        assert torch.isfinite(a).all()
        if k == len(got) + 2:
            # fc_full's bias: BN1 makes the loss invariant to it, so its
            # gradient is roundoff on both paths
            continue
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-2 * max(scale, 1e-6), k


@pytest.mark.parametrize("n,m,f", [(7832, 12, 64), (37, 8, 16),
                                   (301, 12, 18), (50, 12, 20),
                                   (300, 1, 64), (200, 5, 64), (150, 7, 64)])
def test_bf16_apply_instance_matches(dev, n, m, f):
    """Kernel 3 on bf16 z: the f32 instance's bits on the widened z, its
    plain version within the f32 tolerances, an f32 sum; one launch of
    the bf16 instance, none of the f32 one; the dispatcher routes a bf16
    z to it."""
    fe, z, mask, cst, _, _ = _epilogue_args(dev, n, m, f)
    zb = z.to(BF16)
    counts = [fe.epilogue_apply_bf16_cuda.launches,
              fe.epilogue_apply_cuda.launches]
    got = fe.epilogue_apply_bf16_cuda(zb, mask, cst)
    torch.cuda.synchronize()
    assert [fe.epilogue_apply_bf16_cuda.launches,
            fe.epilogue_apply_cuda.launches] == [counts[0] + 1, counts[1]]
    assert got.dtype == torch.float32
    assert torch.equal(got, fe.epilogue_apply_cuda(zb.float(), mask, cst))
    torch.testing.assert_close(got, fe.epilogue_apply_reference(zb, mask,
                                                                cst), **TOL)
    assert torch.equal(fe.epilogue_apply(zb, mask, cst, "pallas"), got)
    with pytest.raises(ValueError, match="z must be torch.bfloat16"):
        fe.epilogue_apply_bf16_cuda(z, mask, cst)


def _offset(t, elements=1):
    """A contiguous copy of ``t`` whose data starts ``elements`` elements
    into a flat buffer: its address is off the 16-byte grid."""
    flat = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = flat[elements:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def _kernels_3_and_5(fe, dtype, z, mask, cst, red5, ct):
    return (fe.APPLY_CUDA[dtype](z, mask, cst),
            fe.DZ_CUDA[dtype](z, mask, cst, red5, ct))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("n,m,f", [(7832, 12, 64), (301, 7, 32),
                                   (97, 1, 128), (40, 5, 16)])
def test_epilogue_scalar_path_equals_vector_path(dev, dtype, n, m, f):
    """Kernels 3 and 5 on a z (and, for kernel 5, a ct) one element off
    the 16-byte grid take the scalar path: the vector path's bits on the
    same data, each launch counted once; padding slots (NaN z) give dz 0."""
    fe, z, mask, cst, ct, red5 = _epilogue_args(dev, n, m, f)
    z = z.to(dtype)
    wide = fe.VECTOR_WIDTH[dtype]
    assert fe.vector_width(f, dtype, (z.data_ptr(), cst.data_ptr(),
                                      ct.data_ptr())) == wide
    zo, cto = _offset(z), _offset(ct)
    assert fe.vector_width(f, dtype, (zo.data_ptr(),)) == 1
    assert fe.vector_width(f, dtype, (cto.data_ptr(),)) == 1
    counts = [fe.APPLY_CUDA[dtype].launches, fe.DZ_CUDA[dtype].launches]
    vec = _kernels_3_and_5(fe, dtype, z, mask, cst, red5, ct)
    scalar = _kernels_3_and_5(fe, dtype, zo, mask, cst, red5, ct)
    dz_ct = fe.DZ_CUDA[dtype](z, mask, cst, red5, cto)
    torch.cuda.synchronize()
    assert [fe.APPLY_CUDA[dtype].launches, fe.DZ_CUDA[dtype].launches] == [
        counts[0] + 2, counts[1] + 3]
    assert torch.equal(vec[0], scalar[0])
    assert torch.equal(vec[1], scalar[1]) and torch.equal(vec[1], dz_ct)
    torch.testing.assert_close(vec[0], fe.epilogue_apply_reference(
        z, mask, cst), **TOL)
    assert (vec[1][mask == 0] == 0).all() and torch.isfinite(vec[1]).all()


def test_epilogue_passes_for_every_f(dev):
    """F = 1 .. 130 in both dtypes (each F's vector width or the scalar
    path, blocks of up to 256 threads, partial chunks at M = 5): kernels 3
    and 5 against their plain versions, the bf16 instances bit-equal to
    the f32 ones on the widened z, and the vector path bit-equal to the
    scalar path on a z one element off."""
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    for f in range(1, 131):
        _, z, mask, cst, ct, red5 = _epilogue_args(dev, 37, 5, f, seed=f)
        zb = z.to(BF16)
        for dtype, zz in ((torch.float32, z), (BF16, zb)):
            agg, dz = _kernels_3_and_5(fe, dtype, zz, mask, cst, red5, ct)
            agg_o, dz_o = _kernels_3_and_5(fe, dtype, _offset(zz), mask,
                                           cst, red5, ct)
            assert torch.equal(agg, agg_o) and torch.equal(dz, dz_o), f
            torch.testing.assert_close(agg, fe.epilogue_apply_reference(
                zz, mask, cst), **TOL, msg=f"F={f} {dtype}")
            want = fe.epilogue_dz_reference(zz, mask, cst, red5, ct)
            if dtype == BF16:
                torch.testing.assert_close(dz, want, rtol=2 ** -7,
                                           atol=1e-5, msg=f"F={f} bf16")
                wide = _kernels_3_and_5(fe, torch.float32, zb.float(), mask,
                                        cst, red5, ct)
                assert torch.equal(agg, wide[0]), f
                assert torch.equal(dz, wide[1].to(BF16)), f
            else:
                torch.testing.assert_close(dz, want, **TOL,
                                           msg=f"F={f} f32")
            assert (dz[mask == 0] == 0).all(), f


@pytest.mark.parametrize("case", ["coo_batch", "hub"])
@pytest.mark.parametrize("f", [16, 64, 100])
def test_bf16_segment_sum_instance_matches(dev, case, f):
    """Kernel 6 on bf16 messages: each sum the f32 instance's on the
    widened messages, rounded to bf16 (bit-equal: the same f32 adds in
    the same order), its plain version within one bf16 ulp; the op and
    the gathers' backward route bf16 to it."""
    from cgnn_tpu_torch.ops import scatter
    from cgnn_tpu_torch.ops.segment import gather_fixed_order

    if case == "coo_batch":
        msgs, centers, n = _coo_batch_messages()
        msgs = msgs[:, :f] if msgs.shape[1] >= f else np.tile(
            msgs, (1, -(-f // msgs.shape[1])))[:, :f]
    else:
        centers = np.sort(np.concatenate([np.full(700, 5),
                                          np.arange(0, 90, 3)])).astype(
                                              np.int32)
        n = 100
        msgs = np.random.default_rng(3).normal(size=(len(centers), f))
    m = torch.from_numpy(np.asarray(msgs, np.float32)).to(dev).to(BF16)
    c = torch.from_numpy(centers).to(dev)
    offsets = scatter.segment_offsets(c, n)
    before = scatter.segment_sum_sorted_bf16_cuda.launches
    f32_before = scatter.segment_sum_sorted_cuda.launches
    got = scatter.segment_sum_sorted_bf16_cuda(m, offsets)
    torch.cuda.synchronize()
    assert got.dtype == BF16
    assert torch.equal(got, scatter.segment_sum_sorted_cuda(
        m.float(), offsets).to(BF16))
    want = scatter.segment_sum_sorted_reference(m, offsets)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)
    assert torch.equal(scatter.segment_sum_sorted(m, c, n, impl="pallas"),
                       got)
    x = torch.zeros((n, f), device=dev, dtype=BF16, requires_grad=True)
    gather_fixed_order(x, c, None, offsets, "pallas").backward(m)
    assert torch.equal(x.grad, got)
    assert scatter.segment_sum_sorted_bf16_cuda.launches == before + 3
    assert scatter.segment_sum_sorted_cuda.launches == f32_before + 1


def test_fixed_order_ops_second_derivative_on_the_card(dev):
    """The COO gather differentiated twice with impl='pallas' on the
    card (kernel 6 in the first backward, the gather again in the
    second, kernel 6 in the third) against the same on the CPU with the
    plain version: within TOL, and the card's bits repeat."""
    from cgnn_tpu_torch.data.graph import csr_transpose
    from cgnn_tpu_torch.ops import scatter
    from cgnn_tpu_torch.ops.segment import gather_fixed_order

    rng = np.random.default_rng(4)
    n, e, f = 300, 4000, 32
    idx = rng.integers(0, n, e).astype(np.int32)
    order, offsets = csr_transpose(idx, n)
    x0 = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((e, f)).astype(np.float32)

    def run(device, impl):
        t = [torch.from_numpy(a).to(device) for a in (idx, order, offsets)]
        x = torch.from_numpy(x0).to(device).requires_grad_()
        y = gather_fixed_order(x, t[0], t[1], t[2], impl)
        (g,) = torch.autograd.grad((y * torch.from_numpy(w).to(device)
                                    * y).sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad((g * g).sum(), x)
        return g.detach().cpu(), gg.cpu()

    before = scatter.segment_sum_sorted_cuda.launches
    card = run(dev, "pallas")
    assert scatter.segment_sum_sorted_cuda.launches - before >= 2
    again = run(dev, "pallas")
    plain = run("cpu", "xla")
    for a, b, c in zip(card, again, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo"])
def test_force_train_graph_replays_equal_eager(dev, dense):
    """The force task's train step (forces with create_graph inside)
    captured as a StepGraph and replayed over 3 batches against the same
    steps run eagerly, under deterministic algorithms: every parameter
    and optimizer buffer bit-equal, the metric sums equal, the capture
    left the state as it found it."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import load_trajectory
    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.train import state as tstate
    from cgnn_tpu_torch.train.force_step import make_force_train_step
    from cgnn_tpu_torch.train.graphs import StepGraph, state_guard
    from cgnn_tpu_torch.train.metrics import DeviceSums, fetch_device_sums

    dcfg = DataConfig()
    mcfg = ModelConfig(dense_m=12 if dense else 0)
    graphs = load_trajectory(48, dcfg.featurize_config(), num_atoms=21)
    dm = 12 if dense else None
    nc, ec = capacities_for(graphs, 16, dense_m=dm)
    batches = [b.to(dev) for b in batch_iterator(graphs, 16, nc, ec,
                                                 dense_m=dm, snug=True)][:3]

    def new():
        st, _, _ = tstate.init_train_state(mcfg, dcfg, graphs,
                                           batch_size=16, device=dev,
                                           optim="adam", lr=1e-3,
                                           task="force")
        return st

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, replayed = new(), new()
        step, sums, gsums = make_force_train_step(), DeviceSums(), \
            DeviceSums()
        for b in batches:
            sums.add(step(eager, b))
        before = {k: v.clone() for k, v in
                  replayed.model.state_dict().items()}
        g = StepGraph(lambda b: gsums.add(step(replayed, b)), batches[0],
                      device=dev, kind="train",
                      guard=state_guard(replayed, sums=[gsums]),
                      on_replay=lambda: replayed.optimizer.advance(1))
        assert g.graph is not None
        for k, v in replayed.model.state_dict().items():
            assert torch.equal(v, before[k]), k
        gsums.zero()
        for b in batches:
            g.run(b)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert fetch_device_sums(sums.sums) == fetch_device_sums(gsums.sums)
    for (k, a), b in zip(eager.model.state_dict().items(),
                         replayed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(eager.optimizer.tensors(), replayed.optimizer.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["driver", "per_step"])
def test_dropped_fit_gives_card_memory_back(dev, mode):
    """A ``fit`` that returned and was dropped gives its graphs' pools and
    staged batches back without ``gc.collect()``: nothing of the epoch
    driver, the step runners or their graph caches sits in a reference
    cycle (the collector is off while it runs, so only reference counts
    free them). The second of two fits, after the first made the capture
    stream's cuBLAS workspace (kept for the process), ends within 8 MiB
    of the allocation before it (the parameters' gradients stay with the
    state)."""
    import gc

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.train import state as tstate
    from cgnn_tpu_torch.train.loop import fit

    dcfg = DataConfig()
    graphs = load_synthetic(96, dcfg.featurize_config(), seed=3)
    st, _, _ = tstate.init_train_state(ModelConfig(dense_m=12), dcfg,
                                       graphs[:64], batch_size=16,
                                       device=dev)
    kw = dict(epochs=2, batch_size=16, dense_m=12, device=dev,
              log_fn=lambda *a: None, scan_epochs=mode == "driver",
              buckets=2)
    st, _ = fit(st, graphs[:64], graphs[64:], **kw)  # the warm fit
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    gc.disable()
    try:
        st, out = fit(st, graphs[:64], graphs[64:], **kw)
        assert out["graphs"]["captures"] > 0
        del out
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        gc.enable()
    assert peak > before
    assert after - before < 8 * 2**20, (before, peak, after)


def _driver_setup(dev):
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic
    from cgnn_tpu_torch.train import state as tstate

    dcfg = DataConfig()
    graphs = load_synthetic(160, dcfg.featurize_config(), seed=3)
    cfg = ModelConfig(atom_fea_len=32, n_conv=2, dense_m=12,
                      cgconv_impl="pallas")

    def fresh():
        return tstate.init_train_state(cfg, dcfg, graphs[:128],
                                       batch_size=16, device=dev, seed=5)

    return graphs, fresh


@pytest.mark.parametrize("level", ["off", "step"])
def test_deferred_pair_fetch_on_the_card_equals_the_joined_one(
        dev, tmp_path, level):
    """``fit`` under the epoch driver on the card, the kernel path, two
    size classes: the deferred bookkeeping (no hook: each pair's sums
    copied out before the next epoch zeroes its accumulators in place,
    and fetched while that epoch runs), at telemetry ``off`` and
    ``step``, against the same run with a checkpoint hook (each fetch
    joined before the next epoch): the same epoch means and final
    parameters, bit for bit, and the deferred epochs' seconds within
    the run's wall."""
    import time

    from cgnn_tpu_torch.observe.telemetry import Telemetry
    from cgnn_tpu_torch.train.loop import fit

    graphs, fresh = _driver_setup(dev)
    kw = dict(epochs=5, batch_size=16, dense_m=12, device=dev, seed=7,
              log_fn=lambda *a: None, scan_epochs=True, buckets=2)
    outs = {}
    for mode in ("joined", "deferred"):
        st, nc, ec = fresh()
        tel = Telemetry(level if mode == "deferred" else "off",
                        str(tmp_path / mode))
        t0 = time.perf_counter()
        st, res = fit(st, graphs[:128], graphs[128:], node_cap=nc,
                      edge_cap=ec, telemetry=tel,
                      on_epoch_end=(lambda *a: None) if mode == "joined"
                      else None, **kw)
        wall = time.perf_counter() - t0
        tel.close()
        outs[mode] = (res["history"], {k: v.detach().clone() for k, v in
                                       st.model.state_dict().items()})
        assert res["graphs"]["captures"] > 0
        assert res["graphs"]["captures_after_warm"] == 0
    (h0, s0), (h1, s1) = outs["joined"], outs["deferred"]
    assert len(h0) == len(h1) == kw["epochs"]
    for a, b in zip(h0, h1):
        for part in ("train", "val"):
            # step level adds the grad-health means; the rest are equal
            assert {k: b[part][k] for k in a[part]} == a[part], part
    for k, v in s0.items():
        assert torch.equal(s1[k], v), k
    assert all(h["seconds"] > 0 for h in h1)
    assert sum(h["seconds"] for h in h1) <= wall


def test_async_pair_fetch_on_the_card_equals_the_sync_one(dev):
    """``ScanEpochDriver.run_epoch_pair`` on the card, kernel path, two
    size classes: ``async_fetch=True`` (the sums stacked into a fresh
    tensor, copied to page-locked memory and waited for on a thread)
    against the synchronous return, epoch after epoch: the same
    schedules, means and parameters, bit for bit."""
    from cgnn_tpu_torch.data.graph import bucketed_batch_iterator
    from cgnn_tpu_torch.train import loop as tloop
    from cgnn_tpu_torch.train.step import make_eval_step, make_train_step

    graphs, fresh = _driver_setup(dev)
    outs = []
    for async_fetch in (False, True):
        state, nc, ec = fresh()
        rng = np.random.default_rng(3)
        batches = list(bucketed_batch_iterator(
            graphs[:128], 16, 2, shuffle=True, rng=rng, dense_m=12))
        vals = list(bucketed_batch_iterator(graphs[128:], 16, 2,
                                            dense_m=12))
        drv = tloop.ScanEpochDriver(make_train_step(), make_eval_step(),
                                    batches, vals, rng, device=dev)
        drv.trace = []
        drv.warm(state)
        means = []
        for epoch in range(5):
            if async_fetch:
                state, pending = drv.run_epoch_pair(
                    state, first=epoch == 0, async_fetch=True)
                means.append(pending.result())
            else:
                state, tm, vm = drv.run_epoch_pair(state, first=epoch == 0)
                means.append((tm, vm))
        outs.append((means, [(k, list(c)) for k, c in drv.trace],
                     {k: v.detach().clone() for k, v in
                      state.model.state_dict().items()}))
    (m0, t0, s0), (m1, t1, s1) = outs
    assert m0 == m1 and t0 == t1
    assert len({k for k, _ in t0}) == 4  # two classes, train and eval
    for k, v in s0.items():
        assert torch.equal(s1[k], v), k


def test_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Data parallel on one card: two ranks of the train entry point over
    gloo on cuda:0 (chip_smoke's ``DataParallelRun``), the kernel path:
    equal state digests after every epoch, the same summed metrics, no
    capture after warm-up, and each rank's kernel launches exact on the
    card (``check_path`` against its own steps)."""
    import chip_smoke as c

    argv = ["--synthetic", "96", "-b", "16", "--epochs", str(c.DP_EPOCHS),
            "--atom-fea-len", "16", "--h-fea-len", "24", "--n-conv", "2",
            "--cgconv-impl", "pallas", "--print-freq", "0",
            "--data-parallel", "--dist-backend", "gloo"]
    traces = c.DataParallelRun("dp_card", str(tmp_path), argv).wait()
    counts = {}
    c.dp_hold("dp_card", traces, c.dense_per_step(2), counts)
    assert sorted(counts) == ["dp_card.rank0", "dp_card.rank1"]
    for rec in counts.values():
        for k in ("fused_cgconv_eval", "fused_cgconv_stats",
                  "epilogue_reduce", "epilogue_dz"):
            assert rec["launches"][k] > 0, (k, rec)


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_graph_shards_two_gloo_ranks_share_the_card(dev, tmp_path, layout):
    """Graph sharding on one card: ``--graph-shards 2`` over gloo on
    cuda:0 (chip_smoke's ``DataParallelRun``), dense node strips and COO
    edge chunks with kernel 6: equal state digests after every epoch,
    the same summed metrics, eager steps (no capture), each rank's
    launches exact (kernel 6's, COO, on its chunk), and per-epoch metrics
    within chip_smoke's ``GS_RTOL`` of one unsharded process at the same
    capacities."""
    import chip_smoke as c

    caps = (["--node-cap", "96"] if layout == "dense" else
            ["--aggregation", "pallas", "--node-cap", "160", "--edge-cap",
             "2400"])
    base = ["--synthetic", "96", "-b", "16", "--epochs", str(c.DP_EPOCHS),
            "--atom-fea-len", "16", "--h-fea-len", "24", "--n-conv", "2",
            "--print-freq", "0", *caps]
    traces = c.DataParallelRun(
        f"gs_card_{layout}", str(tmp_path),
        base + ["--graph-shards", "2", "--dist-backend", "gloo"]).wait()
    counts = {}
    leg = c.dp_hold(f"gs_card_{layout}", traces,
                    c.coo_per_step(2) if layout == "coo" else {}, counts,
                    captured=False)
    if layout == "coo":
        for rec in counts.values():
            assert rec["launches"]["segment_sum_sorted"] > 0, rec
    one = c.gs_one_process(f"gs_card_{layout}_one", base + [
        "--ckpt-dir", str(tmp_path / "one_ck"), "--out-dir",
        str(tmp_path / "one_out")])
    c.dp_against_emulation(f"gs_card_{layout}", leg, {
        "train_loss": one["train_loss"], "val_mae": one["val_metric"]},
        rtol=c.GS_RTOL, what="one unsharded process")
    c.gs_edge_bytes(f"gs_card_{layout}", leg, one)


# two ranks of ``fit`` under the epoch driver on cuda:0, replayed and
# eager: python -c DP_DRIVER_RANK rank port out
DP_DRIVER_RANK = r'''
import sys
import numpy as np
import torch
from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data.dataset import load_synthetic
from cgnn_tpu_torch.parallel import dist
from cgnn_tpu_torch.parallel.data_parallel import state_digest
from cgnn_tpu_torch.train.loop import fit
from cgnn_tpu_torch.train.state import init_train_state

rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.use_deterministic_algorithms(True, warn_only=True)
dist.initialize(f"localhost:{port}", 2, rank, backend="gloo", timeout_s=120,
                log_fn=lambda *a: None)
graphs = load_synthetic(96, DataConfig(max_num_nbr=8).featurize_config(),
                        seed=4)
train, val = graphs[:80], graphs[80:]
out = {}
try:
    for replay in (True, False):
        state, nc, ec = init_train_state(
            ModelConfig(atom_fea_len=16, n_conv=2, h_fea_len=24, dense_m=8,
                        cgconv_impl="pallas"),
            DataConfig(max_num_nbr=8), train, batch_size=16, device="cuda",
            seed=0)
        state, res = fit(state, dist.host_shard(train), dist.host_shard(val),
                         epochs=2, batch_size=16, dense_m=8, device="cuda",
                         node_cap=nc, edge_cap=ec, seed=1, buckets=2,
                         scan_epochs=True, graphs=replay, guard=True,
                         log_fn=lambda *a: None, fit_on=(train, val))
        out[replay] = {"digest": state_digest(state),
                       "digests": res["dp"]["digests"],
                       "graphs": res["graphs"],
                       "metrics": [(h["train"], h["val"])
                                   for h in res["history"]]}
finally:
    dist.shutdown()
torch.save(out, sys.argv[3])
'''


def test_dp_driver_replayed_split_step_equals_eager(dev, tmp_path):
    """Two gloo ranks on the card under the epoch driver with the kernel
    path: graph A a shape, the host's all-reduce, graph B, replayed,
    against the same driver stepping eagerly (``graphs=False``) under
    deterministic algorithms: the same bits after every epoch, and the
    same per-epoch metrics, on both ranks."""
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("CGNN_")}
    env.update(PYTHONPATH=root, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_DRIVER_RANK, str(r), str(port),
         str(tmp_path / f"out{r}.pt")], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    for out in outs:
        replayed, eager = out[True], out[False]
        assert replayed["graphs"]["captures"] > 0
        assert replayed["graphs"]["captures_after_warm"] == 0
        assert eager["graphs"]["captures"] == 0
        assert replayed["digests"] == eager["digests"]
        assert replayed["digest"] == eager["digest"]
        assert replayed["metrics"] == eager["metrics"]
    assert outs[0][True]["digests"] == outs[1][True]["digests"]
