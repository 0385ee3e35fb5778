"""Ladder packing in the port (``--packing ladder``) against the JAX
package's, and the user capacities:

- ``round_to_bucket`` over n = 1 .. 10^5 at three ladder floors, and
  ``capacities_for(snug=False)`` dense and COO over batch sizes and
  headrooms: the same integers;
- ``batch_iterator``/``bucketed_batch_iterator(snug=False)`` (training
  batches shuffled from one seed, evaluation batches, COO, compact) and
  ``pad_batch``: every array bit-equal, the generators left in the same
  state; ``plan_batches``/``count_batches`` with ``snug=False`` agree
  with what the iterator yields;
- ``PaddingStats``: ``summary()`` equal as a string, efficiencies and
  ``per_shape`` equal, for snug and ladder batches;
- ``fit(packing='ladder')`` on a small model, the eager loop and the
  epoch driver, against the JAX ``fit(snug=False)`` with SGD from the
  same weights: per-epoch metrics within rel 1e-5 (the trajectory tests'
  tolerance, tests/test_torch_driver.py);
- the entry points on the CPU: train with ``--packing ladder``,
  ``--node-cap``/``--edge-cap`` (honoured by COO, the edge cap warned
  about and ignored by the dense layout, as train.py does), and predict
  with ``--packing ladder`` against the snug answers (rtol 1e-5, atol
  2e-6: the same graphs in other batch shapes).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cgnn_tpu.data import compact as jcompact
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic_mp
from cgnn_tpu.train.loop import fit as jfit
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu_torch.data import compact as tcompact
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.predict import main as predict_main
from cgnn_tpu_torch.train.__main__ import main as train_main
from cgnn_tpu_torch.train.loop import fit
from test_torch_driver import (
    EPOCHS,
    KW,
    SGD,
    _close,
    _fresh,
    _port_fit,
    setup,  # noqa: F401 — the fixture
)
from test_torch_train import SMALL, JNet
from test_torch_train import M as TRAIN_M
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

CFG = FeaturizeConfig(radius=6.0, max_num_nbr=12)
M = 12


def _port(g) -> tgraph.CrystalGraph:
    return tgraph.CrystalGraph(
        atom_fea=g.atom_fea, edge_fea=g.edge_fea, centers=g.centers,
        neighbors=g.neighbors, target=g.target, cif_id=g.cif_id,
        target_mask=g.target_mask, distances=g.distances)


@pytest.fixture(scope="module")
def data():
    jg = load_synthetic_mp(80, CFG, seed=6)
    return jg, [_port(g) for g in jg]


@pytest.mark.parametrize("minimum", [16, 64, 128])
def test_round_to_bucket_equal(minimum):
    for n in range(1, 100_001):
        assert tgraph.round_to_bucket(n, minimum) == \
            jgraph.round_to_bucket(n, minimum), n
    assert tgraph.round_to_bucket(1000, minimum, 1.5) == \
        jgraph.round_to_bucket(1000, minimum, 1.5)


@pytest.mark.parametrize("dense_m", [None, M])
def test_ladder_capacities_equal(data, dense_m):
    jg, tg = data
    for bs in (1, 4, 8, 16, 64, 256):
        for headroom in (1.0, 1.15, 1.5):
            for snug in (False, True):
                want = jgraph.capacities_for(jg, bs, headroom,
                                             dense_m=dense_m, snug=snug)
                got = tgraph.capacities_for(tg, bs, headroom,
                                            dense_m=dense_m, snug=snug)
                assert got == want, (bs, headroom, snug)
    # the ladder leaves room for batch_size graphs, the snug mode does not
    assert tgraph.capacities_for(tg, 16, snug=False)[0] > \
        tgraph.capacities_for(tg, 16, snug=True)[0]


def _assert_equal(got, want):
    for field, a in got.numpy().items():
        if field in tgraph.PORT_FIELDS:
            continue  # the port's COO transpose (tests/test_torch_coo.py)
        b = getattr(want, field)
        if a is None:
            assert b is None, field
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("case,buckets", [
    (case, buckets) for case in ("train", "eval", "coo", "compact")
    for buckets in (0, 1, 3)] + [("drop_last", 0), ("per_bucket", 3)])
def test_ladder_batches_bit_equal(data, case, buckets):
    """``buckets`` 0: ``batch_iterator`` at the dataset's ladder
    capacities (``drop_last`` is its alone); else
    ``bucketed_batch_iterator`` (``per_bucket``: single-tier transpose
    slots sized by each class's worst in-degree)."""
    jg, tg = data
    dense_m = None if case == "coo" else M
    kw = {"train": dict(shuffle=True), "eval": dict(in_cap=0),
          "coo": dict(shuffle=True), "compact": dict(shuffle=True),
          "drop_last": dict(shuffle=True, drop_last=True),
          "per_bucket": dict(shuffle=True, per_bucket_in_cap=True)}[case]
    jkw, tkw = {}, {}
    if case == "compact":
        jkw["pack_fn"] = jcompact.compact_pack_fn(
            jcompact.CompactSpec.build(jg, CFG.gdf(), dense_m=M))
        tkw["pack_fn"] = tcompact.compact_pack_fn(
            tcompact.CompactSpec.build(tg, CFG.gdf(), dense_m=M))
    jrng, trng = np.random.default_rng(8), np.random.default_rng(8)
    bs = 6
    if buckets:
        jstats, tstats = jgraph.PaddingStats(), tgraph.PaddingStats()
        want = list(jgraph.bucketed_batch_iterator(
            jg, bs, buckets, rng=jrng, dense_m=dense_m, snug=False,
            stats=jstats, **kw, **jkw))
        got = list(tgraph.bucketed_batch_iterator(
            tg, bs, buckets, rng=trng, dense_m=dense_m, snug=False,
            stats=tstats, **kw, **tkw))
        assert tstats.summary() == jstats.summary()
        assert tstats.per_shape == jstats.per_shape
    else:
        nc, ec = jgraph.capacities_for(jg, bs, dense_m=dense_m, snug=False)
        want = list(jgraph.batch_iterator(jg, bs, nc, ec, rng=jrng,
                                          dense_m=dense_m, snug=False, **kw,
                                          **jkw))
        got = list(tgraph.batch_iterator(tg, bs, nc, ec, rng=trng,
                                         dense_m=dense_m, snug=False, **kw,
                                         **tkw))
        if case == "eval":
            assert len(got) == tgraph.count_batches(tg, bs, nc, ec) == len(
                list(tgraph.plan_batches(tg, bs, nc, ec)))
    assert len(got) == len(want) > max(buckets, 3)
    for a, b in zip(got, want):
        if case == "compact":
            for field, x in a.numpy().items():
                y = getattr(b, field)
                assert (x is None) == (y is None), field
                if x is not None:
                    np.testing.assert_array_equal(x, np.asarray(y),
                                                  err_msg=field)
        else:
            _assert_equal(a, b)
        # ladder batches close at batch_size graphs
        assert int(a.graph_mask.sum()) <= bs == a.graph_mask.shape[0]
    assert trng.bit_generator.state == jrng.bit_generator.state


def test_pad_batch_equal(data):
    jg, tg = data
    for lo, hi in ((0, 3), (10, 18), (30, 31)):
        _assert_equal(tgraph.pad_batch(tg[lo:hi], 8),
                      jgraph.pad_batch(jg[lo:hi], 8))


@pytest.mark.parametrize("snug", [True, False])
def test_padding_stats_summary_equal(data, snug):
    jg, tg = data
    nc, ec = jgraph.capacities_for(jg, 8, dense_m=M, snug=snug)
    jstats, tstats = jgraph.PaddingStats(), tgraph.PaddingStats()
    want = list(jstats.wrap(jgraph.batch_iterator(
        jg, 8, nc, ec, dense_m=M, snug=snug, in_cap=0)))
    got = list(tstats.wrap(tgraph.batch_iterator(
        tg, 8, nc, ec, dense_m=M, snug=snug, in_cap=0)))
    assert len(got) == len(want) == tstats.batches
    assert tstats.summary() == jstats.summary()
    assert tstats.summary().startswith("padding efficiency: nodes ")
    for key in ("real_nodes", "real_edges", "slot_nodes", "slot_edges",
                "shapes", "per_shape"):
        assert getattr(tstats, key) == getattr(jstats, key), key
    assert tstats.node_efficiency == jstats.node_efficiency
    assert tstats.edge_efficiency == jstats.edge_efficiency
    assert tgraph.PaddingStats().summary() == jgraph.PaddingStats().summary()


def _jax_fit_ladder(setup, **kw):  # noqa: F811 — the fixture's value
    train_g, val_g, variables = setup
    jnet = JNet(**SMALL, dense_m=TRAIN_M)
    tx = jmake_optimizer("sgd", **SGD)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(np.stack([g.target for g in train_g])),
        rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    logs = []
    _, res = jfit(jstate, train_g, val_g, epochs=EPOCHS, snug=False,
                  **dict(KW, log_fn=logs.append), **kw)
    return res["history"], logs


@pytest.mark.parametrize("mode", [{}, dict(scan_epochs=True),
                                  dict(scan_epochs=True, buckets=2)],
                         ids=["eager", "driver", "driver_buckets2"])
def test_fit_ladder_matches_the_jax_fit(setup, mode):  # noqa: F811
    want, jlogs = _jax_fit_ladder(setup, **mode)
    train_g, val_g, _ = setup
    logs = []
    _, got = fit(_fresh(setup, "sgd", SGD), [_port(g) for g in train_g],
                 [_port(g) for g in val_g], epochs=EPOCHS, device="cpu",
                 packing="ladder", **dict(KW, log_fn=logs.append), **mode)
    _close(got["history"], want)
    # the first epoch's padding line, as the JAX loop logs it
    pad = [line for line in logs if line.startswith("padding efficiency")]
    assert pad == [line for line in jlogs
                   if line.startswith("padding efficiency")]
    assert len(pad) == 1 and got["padding"]["summary"] == pad[0]
    assert 0 < got["padding"]["node_efficiency"] < 1


def test_fit_refuses_an_unknown_packing(setup):  # noqa: F811
    with pytest.raises(ValueError, match="packing"):
        _port_fit(setup, _fresh(setup, "sgd", SGD), packing="tight")


def _argv(tmp_path, *extra):
    return ["--synthetic", "48", "--device", "cpu", "--epochs", "1", "-b",
            "8", "--radius", "5", "--n-conv", "2", "--atom-fea-len", "16",
            "--print-freq", "0", "--ckpt-dir", str(tmp_path / "ck"),
            "--out-dir", str(tmp_path / "out"), *extra]


def _summary(out: str) -> dict:
    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])


@pytest.mark.parametrize("flags", [
    [], ["--device-resident", "--buckets", "2", "--check-invariants"],
    ["--aggregation", "pallas", "--scan-epochs"]],
    ids=["eager", "driver_buckets2", "coo_driver"])
def test_train_entry_point_ladder(tmp_path, capsys, flags):
    assert train_main(_argv(tmp_path, "--packing", "ladder", *flags)) == 0
    out = capsys.readouterr().out
    summary = _summary(out)
    assert summary["padding"]["summary"] in out
    assert 0 < summary["padding"]["node_efficiency"] < 1
    assert (tmp_path / "out" / "params.npz").exists()
    assert train_main(_argv(tmp_path, *flags)) == 0  # snug, the default
    snug = _summary(capsys.readouterr().out)["padding"]
    # fill-to-capacity packing pads less than the ladder
    assert snug["node_efficiency"] > summary["padding"]["node_efficiency"]


def test_user_caps(tmp_path, capsys, monkeypatch):
    """COO honours both caps; the dense layout takes --node-cap and warns
    that --edge-cap is ignored (its edge capacity is node_cap x M)."""
    from cgnn_tpu_torch.train import loop

    seen = []
    real = loop.fit

    def spy(*a, **k):
        seen.append((k["node_cap"], k["edge_cap"]))
        return real(*a, **k)

    monkeypatch.setattr(loop, "fit", spy)
    assert train_main(_argv(tmp_path, "--aggregation", "pallas",
                            "--node-cap", "160", "--edge-cap", "1900")) == 0
    assert train_main(_argv(tmp_path, "--node-cap", "96", "--edge-cap",
                            "1900")) == 0
    assert seen == [(160, 1900), (96, 96 * 12)]  # --max-num-nbr 12
    err = capsys.readouterr().err
    assert err.count("--edge-cap 1900 ignored by the dense layout") == 1
    assert f"node_cap * max_num_nbr = {96 * 12}" in err


def test_user_caps_shape_the_batches(tmp_path, monkeypatch):
    """The caps reach the staged batches: every COO batch of the driver
    is (node_cap, edge_cap) in shape."""
    from cgnn_tpu_torch.train import loop

    shapes = set()
    real = loop.ScanEpochDriver.__init__

    def spy(self, train_body, eval_body, train_batches, val_batches, *a,
            **k):
        shapes.update((b.node_capacity, b.edge_capacity)
                      for b in train_batches + val_batches)
        real(self, train_body, eval_body, train_batches, val_batches, *a,
             **k)

    monkeypatch.setattr(loop.ScanEpochDriver, "__init__", spy)
    assert train_main(_argv(tmp_path, "--aggregation", "pallas",
                            "--scan-epochs", "--node-cap", "200",
                            "--edge-cap", "2000")) == 0
    assert shapes == {(200, 2000)}


def test_predict_ladder_against_snug(tmp_path, capsys):
    assert train_main(_argv(tmp_path)) == 0
    out = {}
    for packing in ("snug", "ladder"):
        out[packing] = str(tmp_path / f"{packing}.csv")
        assert predict_main([str(tmp_path / "ck"), "--device", "cpu",
                             "--synthetic", "20", "-b", "6", "--buckets",
                             "2", "--packing", packing,
                             "--out", out[packing]]) == 0
    rows = {}
    for packing, path in out.items():
        with open(path) as f:
            rows[packing] = [line.strip().split(",") for line in f]
    assert [r[0] for r in rows["ladder"]] == [r[0] for r in rows["snug"]]
    np.testing.assert_allclose(
        np.array([[float(v) for v in r[1:]] for r in rows["ladder"]]),
        np.array([[float(v) for v in r[1:]] for r in rows["snug"]]),
        rtol=1e-5, atol=2e-6)
