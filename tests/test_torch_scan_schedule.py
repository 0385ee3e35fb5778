"""The port's epoch driver walks the JAX ``ScanEpochDriver``'s step
sequence, element by element.

As in tests/test_scan_schedule.py the JAX driver's scan bodies are
stubbed (only its scheduling runs) and record each dispatched chunk: its
shape group and the batch indices of its permutation. The port's driver
runs its real step path on the CPU with a stub body that records which
batch its device-side read (``stacked[perm[cursor]]``) took; its host
trace of the chunks must equal both. Same group sizes (85/80/90
batches), seeds and 10 epochs as the JAX test, with small batches (the
scheduler sees only shapes), plus a single-group driver (no tail, no
weighted picks) and a first epoch in packing order.
"""

import numpy as np
import pytest
import torch

from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic_mp
from cgnn_tpu.data.graph import pack_graphs as jpack_graphs
from cgnn_tpu.train.loop import ScanEpochDriver as JDriver
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.graph import pack_graphs as tpack_graphs
from cgnn_tpu_torch.train.loop import ScanEpochDriver
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

CFG = FeaturizeConfig(radius=6.0, max_num_nbr=12)
EPOCHS = 10
GROUPS = {"three": (85, 80, 90), "one": (40,)}


def _port(g) -> CrystalGraph:
    return CrystalGraph(atom_fea=g.atom_fea, edge_fea=g.edge_fea,
                        centers=g.centers, neighbors=g.neighbors,
                        target=g.target, cif_id=g.cif_id)


@pytest.fixture(scope="module")
def graphs():
    return load_synthetic_mp(6, CFG, seed=0)


def _batches(graphs, sizes):
    """Per group, ``size`` copies of one packed batch of two graphs at
    the group's own node capacity: JAX batches, and port batches whose
    ``targets[0, 0]`` is the batch's index (what the stub body reads)."""
    jb, tb = [], []
    for gi, size in enumerate(sizes):
        sub = graphs[2 * gi: 2 * gi + 2]
        nc = 200 + 40 * gi
        j = jpack_graphs(sub, nc, nc * 12, 2, dense_m=12)
        for _ in range(size):
            t = tpack_graphs([_port(g) for g in sub], nc, nc * 12, 2,
                             dense_m=12)
            t.targets[0, 0] = float(len(tb))
            jb.append(j)
            tb.append(t)
    return jb, tb


def jax_sequence(batches, chunk_steps, seed, first_epoch):
    drv = JDriver(lambda s, b: (s, {}), lambda s, b: {}, batches, [],
                  np.random.default_rng(seed), chunk_steps=chunk_steps)
    keys = list(drv._train_groups)
    seq = []

    def fake_scan_fn(cache, key, body, train):
        def fn(state, stacked, perm):
            seq.append((keys.index(key[0]), np.asarray(perm).tolist()))
            return state, {}

        return fn

    drv._scan_fn = fake_scan_fn
    for e in range(EPOCHS):
        drv._drive(None, drv._train_groups, {}, None, train=True,
                   first=first_epoch and e == 0)
    return seq


def port_sequence(batches, chunk_steps, seed, first_epoch):
    taken = []

    def body(state, batch):
        taken.append(int(batch.targets[0, 0]))
        return {"count": batch.targets.new_ones(())}

    drv = ScanEpochDriver(body, body, batches, [],
                          np.random.default_rng(seed), device="cpu",
                          chunk_steps=chunk_steps)
    keys = list(drv._train_groups)
    offsets = np.cumsum([0] + [g.n for g in drv._train_groups.values()])
    drv.trace = []
    for e in range(EPOCHS):
        drv._drive(None, drv._train_groups, train=True,
                   first=first_epoch and e == 0)
    seq = [(keys.index(k), idx.tolist()) for k, idx in drv.trace]
    # the device-side reads, as batch indices within their group
    flat = [(gi, i) for gi, idx in seq for i in idx]
    assert [offsets[gi] + i for gi, i in flat] == taken
    return seq, drv


@pytest.mark.parametrize("first_epoch", [False, True])
@pytest.mark.parametrize("chunk_steps", [1, 2, 4])
@pytest.mark.parametrize("groups", sorted(GROUPS))
def test_step_sequence_equals_the_jax_driver(graphs, groups, chunk_steps,
                                             first_epoch):
    jb, tb = _batches(graphs, GROUPS[groups])
    want = jax_sequence(jb, chunk_steps, 0, first_epoch)
    got, drv = port_sequence(tb, chunk_steps, 0, first_epoch)
    assert len(got) == len(want)
    assert got == want
    assert drv.timings["train_steps"] == EPOCHS * sum(GROUPS[groups])
    if groups == "three":  # the weighted picks interleave the groups
        assert len({gi for gi, _ in got[:40]}) == 3


def test_another_seed_gives_another_sequence(graphs):
    jb, tb = _batches(graphs, GROUPS["three"])
    a, _ = port_sequence(tb, 2, 0, False)
    b, _ = port_sequence(tb, 2, 1, False)
    assert a != b
    assert jax_sequence(jb, 2, 1, False) == b


def test_eval_drive_is_arange_and_draws_nothing(graphs):
    """An eval epoch runs every group in packing order and leaves the
    generator where it was; ``chunk_steps`` < 1 is refused."""
    _, tb = _batches(graphs, GROUPS["three"])
    rng = np.random.default_rng(5)
    drv = ScanEpochDriver(lambda s, b: {}, lambda s, b: {}, tb[:3], tb[85:88],
                          rng, device="cpu")
    state_before = rng.bit_generator.state
    drv.trace = []
    drv._drive(None, drv._val_groups, train=False, first=True)
    assert [i.tolist() for _, i in drv.trace] == [[0, 1], [2]]
    assert rng.bit_generator.state == state_before
    with pytest.raises(ValueError):
        ScanEpochDriver(lambda s, b: {}, lambda s, b: {}, tb[:3], [],
                        rng, device="cpu", chunk_steps=0)
    assert torch.equal(drv._val_groups[next(iter(drv._val_groups))]
                       .cursor, torch.tensor(3))
