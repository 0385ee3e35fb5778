"""Bulk predict with the port (``predict.py``'s counterpart):

    python -m cgnn_tpu_torch.predict CKPT_DIR DATA_DIR --out preds.csv
    python -m cgnn_tpu_torch.predict CKPT_DIR --cache graphs.npz --compact on
    python -m cgnn_tpu_torch.predict CKPT_DIR --synthetic 64 --device cpu

Loads a checkpoint directory written by ``python -m cgnn_tpu_torch.train``
(or converted from a ``train.py`` one by ``jax_checkpoint_to_torch.py``):
the model and featurization configs from its meta, the weights and the
normalizer through ``train.checkpoint.load_for_inference`` (``--best``
for the best save, else the newest restorable one). It predicts and writes
``predict.py``'s CSV rows, ``id, target..., prediction...``, each number
``%.6f``, in input order. A classifier's prediction columns are its
``num_classes`` log-probs; a multi-task model's, its T targets. A bf16
model (``dtype`` in the meta) stages its edge features in bf16 on every
wire.

Data, as in ``predict.py``: ``--cache PATH`` (a graph cache, data/cache.py;
a missing file exits 2), else ``--synthetic N``, else the CIF directory
``DATA_DIR`` (``{id}.cif`` + ``id_prop.csv``), featurized here with its
geometry kept when the raw wire is wanted, so ``--wire raw`` on a CIF
directory builds the graphs on the device. A cache holds no atomic
numbers, so its graphs take the featurized wire.

Paths, as in ``predict.py``: ``--buckets N`` packs N size classes at
their own snug capacities; by default batches pack into a shape ladder of
``--rungs`` rungs. On the ladder, ``--wire raw`` stages the structures
that fit the raw caps as positions, lattice and species, and the device
builds their graphs (kernel 8 on the card); the rest, and any structure
the device flags for cap overflow, take the featurized wire. ``--wire
auto`` is raw on the card and featurized on the CPU. The default device
is the card, which raises without one; ``--device cpu`` runs the kernels'
plain versions.

``--compact on`` stages the featurized batches compactly (atoms and
distances; the device rebuilds the batch, data/compact.py) into pooled
staging buffers; ``auto`` does so on the card with the dense layout,
``off`` never. Data that cannot stage compactly is reported: ``auto``
then packs full, ``on`` exits 2. ``--pack-workers K`` packs on K threads
(default: 4 on the card, 0 on the CPU).

A force-field checkpoint (meta ``task: force``) predicts as
``predict.py`` does for it: ``--synthetic N`` LJ trajectory frames, a
trajectory ``.npz`` or directory as ``DATA_DIR`` (else CIFs, geometry
kept), or a cache with geometry; snug batches carrying the gathers'
transpose, each step a replayed CUDA graph on the card (one graph a
batch shape, captured at its first batch); CSV rows ``id, target,
energy``, and ``<out>.forces.npz`` with ``ids`` and ``forces_<i>``, the
i-th structure's [n_atoms, 3] forces in original units.

Not ported yet; each exits 2 naming its ROADMAP item (Queue 1):
``--packing ladder`` (item 10), ``--devices`` other than auto or 1 and
``--engine mesh`` (items 9 and 11).
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cgnn_tpu_torch.predict",
        description="Bulk predict with the PyTorch/CUDA port.")
    p.add_argument("ckpt_dir", help="checkpoint directory written by "
                                    "python -m cgnn_tpu_torch.train")
    p.add_argument("root_dir", nargs="?", default=None,
                   help="dataset dir: {id}.cif files + id_prop.csv")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--best", action="store_true",
                   help="load the best checkpoint instead of the latest")
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--out", default="test_results.csv")
    p.add_argument("--synthetic", type=int, default=0,
                   help="predict on N synthetic structures")
    p.add_argument("--cache", type=str, default="",
                   help="featurized graph cache (.npz, python -m "
                        "cgnn_tpu_torch.data.preprocess)")
    p.add_argument("--packing", choices=["snug", "ladder"], default="snug",
                   help="snug = fill-to-capacity batches")
    p.add_argument("--buckets", type=int, default=0,
                   help="per-size-class capacities (3 for mixed sizes); "
                        "the default packs into the shape ladder (--rungs)")
    p.add_argument("--rungs", type=int, default=2,
                   help="shape-ladder depth")
    p.add_argument("--pack-workers", type=int, default=None,
                   help="host pack threads (default: 4 on the card, 0 on "
                        "the CPU)")
    p.add_argument("--wire", choices=["auto", "raw", "featurized"],
                   default="auto",
                   help="'raw' builds the graphs on the device; 'auto' is "
                        "raw on the card, featurized on the CPU")
    p.add_argument("--compact", choices=["auto", "on", "off"],
                   default="auto",
                   help="compact staging of featurized batches; auto = on "
                        "the card with the dense layout")
    p.add_argument("--devices", default="auto", metavar="{auto,N}",
                   help="devices to dispatch over (one card only so far)")
    p.add_argument("--engine", choices=["auto", "mesh", "threads"],
                   default="auto",
                   help="multi-device execution layer (not ported yet)")
    return p


def _unported(args) -> str | None:
    """Why these arguments ask for something not ported yet, or None."""
    if args.packing == "ladder":
        return ("--packing ladder is not ported yet (ROADMAP Queue 1, item "
                "10)")
    if args.devices not in ("auto", "1") or args.engine == "mesh":
        return ("--devices other than auto/1 and --engine mesh are not "
                "ported yet (ROADMAP Queue 1, items 9 and 11)")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _unported(args)
    if why:
        print(why, file=sys.stderr)
        return 2
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.device import resolve_device
    from cgnn_tpu_torch.train.checkpoint import load_for_inference

    if not (args.cache or args.synthetic or args.root_dir):
        print("DATA_DIR, --cache, or --synthetic is required",
              file=sys.stderr)
        return 2
    if args.cache and not os.path.exists(args.cache):
        print(f"--cache {args.cache} does not exist", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    try:
        state, meta, _ = load_for_inference(
            args.ckpt_dir, "best" if args.best else "latest", dev)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    task = meta.get("task", "regression")
    model_cfg = ModelConfig.from_meta(meta["model"]).for_arbitrary_inputs()
    data_cfg = DataConfig.from_meta(meta["data"])
    if task == "force":
        return _run_force(args, state, model_cfg, data_cfg, dev)
    return _run(args, state, model_cfg, data_cfg, dev)


def _load(args, fcfg, want_raw: bool):
    """The graphs to predict: the cache, the synthetic set or the CIF
    directory (module docstring)."""
    if args.cache:
        from cgnn_tpu_torch.data.cache import load_graph_cache

        graphs = load_graph_cache(args.cache)
        print(f"loaded {len(graphs)} graphs from {args.cache}")
        return graphs
    if args.synthetic:
        from cgnn_tpu_torch.data.dataset import load_synthetic

        return load_synthetic(args.synthetic, fcfg, keep_geometry=want_raw)
    from cgnn_tpu_torch.data.dataset import load_cif_directory

    return load_cif_directory(args.root_dir, fcfg, keep_geometry=want_raw)


def _compact_spec(args, graphs, fcfg, layout_m, dev, edge_dtype):
    """-> (CompactSpec or None, None), or (None, why ``--compact on``
    cannot be served)."""
    if args.compact == "off" or (args.compact == "auto"
                                 and dev.type != "cuda"):
        return None, None
    from cgnn_tpu_torch.data.compact import CompactSpec, CompactUnsupported

    try:
        if layout_m is None:
            raise CompactUnsupported("compact staging requires the dense "
                                     "layout")
        return CompactSpec.build(graphs, fcfg.gdf(), dense_m=layout_m,
                                 edge_dtype=edge_dtype), None
    except CompactUnsupported as e:
        if args.compact == "on":
            return None, f"--compact on: compact staging unavailable ({e})"
        print(f"compact staging unavailable ({e}); using full-fidelity "
              f"packing", file=sys.stderr)
        return None, None


def _run(args, state, model_cfg, data_cfg, dev) -> int:
    import time

    import numpy as np

    from cgnn_tpu_torch.train.infer import (
        _shape_set_plan,
        run_fast_inference,
        run_raw_inference,
    )

    fcfg = data_cfg.featurize_config()
    want_raw = args.wire == "raw" or (args.wire == "auto"
                                      and dev.type == "cuda")
    try:
        graphs = _load(args, fcfg, want_raw)
    except (FileNotFoundError, ValueError) as e:  # no id_prop.csv, no usable CIF
        print(e, file=sys.stderr)
        return 2
    layout_m = model_cfg.dense_m or None
    n_targets = model_cfg.num_targets
    edge_dtype = model_cfg.torch_dtype
    compact, why = _compact_spec(args, graphs, fcfg, layout_m, dev,
                                 edge_dtype)
    if why:
        print(why, file=sys.stderr)
        return 2
    pack_workers = (args.pack_workers if args.pack_workers is not None
                    else 4 if dev.type == "cuda" else 0)
    pipe: dict = {}
    # batches by wire on the ladder (None on the buckets path)
    counts = {"structures": len(graphs), "raw": 0, "batches_raw": None,
              "batches_featurized": None, "compact": compact is not None,
              "pack_workers": pack_workers}
    if args.buckets >= 1:
        # per-size-class snug capacities derived from this dataset
        preds, rate = run_fast_inference(state, graphs, args.batch_size,
                                         buckets=args.buckets,
                                         dense_m=layout_m, compact=compact,
                                         pack_workers=pack_workers,
                                         stats=pipe)
        how = f"{args.buckets} size buckets"
    else:
        from cgnn_tpu_torch.serve.shapes import plan_shape_set

        raw_spec = None
        if want_raw and layout_m is not None:
            from cgnn_tpu_torch.data.rawbatch import (
                RawUnsupported,
                plan_raw_spec,
            )

            try:
                raw_spec = plan_raw_spec(graphs, fcfg.gdf(), fcfg.radius,
                                         layout_m)
            except RawUnsupported as e:
                print(f"raw wire unavailable ({e}); featurized wire",
                      file=sys.stderr)
        shape_set = plan_shape_set(graphs, args.batch_size, rungs=args.rungs,
                                   dense_m=layout_m, num_targets=n_targets,
                                   compact=compact, raw=raw_spec,
                                   edge_dtype=edge_dtype)
        raw_idx: list[int] = []
        raws: list = []
        if raw_spec is not None:
            from cgnn_tpu_torch.data.rawbatch import raw_from_graph

            raws = [raw_from_graph(g) for g in graphs]
            raw_idx = [i for i, r in enumerate(raws)
                       if r is not None and shape_set.admits_raw(r)]
        admitted = set(raw_idx)
        feat_idx = [i for i in range(len(graphs)) if i not in admitted]
        # the model's columns: a classifier's num_classes log-probs, not
        # the label width
        preds = np.zeros((len(graphs), model_cfg.out_dim), np.float32)
        counts["batches_featurized"] = 0
        # one rate over both wires, end to end
        t0 = time.perf_counter()
        if raw_idx:
            by_id = {id(raws[i]): graphs[i] for i in raw_idx}
            preds[raw_idx], _ = run_raw_inference(
                state, [raws[i] for i in raw_idx], shape_set,
                raw_fallback=lambda rs: by_id[id(rs)])
        if feat_idx:
            feat = [graphs[i] for i in feat_idx]
            preds[feat_idx], _ = run_fast_inference(
                state, feat, args.batch_size, shape_set=shape_set,
                pack_workers=pack_workers, stats=pipe)
        rate = len(graphs) / (time.perf_counter() - t0)
        if feat_idx:
            counts["batches_featurized"] = sum(
                1 for _ in _shape_set_plan(feat, shape_set))
        counts["raw"] = len(raw_idx)
        counts["batches_raw"] = math.ceil(len(raw_idx)
                                          / shape_set.largest.graph_cap)
        how = (f"{len(shape_set)}-rung shape ladder, {len(raw_idx)}/"
               f"{len(graphs)} structures on the raw wire")
    print(f"inference throughput: {rate:.0f} structures/sec ({how}, "
          f"{'compact' if compact is not None else 'full'}-staged, "
          f"{pack_workers} pack workers, {dev})")
    print("predict: " + json.dumps(dict(counts, structures_per_s=rate,
                                        pipeline=pipe), allow_nan=False))
    rows = [[g.cif_id] + [f"{t:.6f}" for t in np.atleast_1d(g.target)]
            + [f"{v:.6f}" for v in p] for g, p in zip(graphs, preds)]
    with open(args.out, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    print(f"wrote {len(rows)} predictions to {args.out}")
    return 0



def _load_force(args, fcfg):
    """The force task's structures (module docstring), geometry kept."""
    if args.cache:
        from cgnn_tpu_torch.data.cache import load_graph_cache

        graphs = load_graph_cache(args.cache)
        print(f"loaded {len(graphs)} graphs from {args.cache}")
        return graphs
    if args.synthetic:
        from cgnn_tpu_torch.data.dataset import load_trajectory

        return load_trajectory(args.synthetic, fcfg)
    from cgnn_tpu_torch.data.trajectory import (
        is_trajectory_path,
        load_trajectory_root,
    )

    if is_trajectory_path(args.root_dir):
        return [g for grp in load_trajectory_root(args.root_dir, fcfg)
                for g in grp]
    from cgnn_tpu_torch.data.dataset import load_cif_directory

    return load_cif_directory(args.root_dir, fcfg, keep_geometry=True)


def _run_force(args, state, model_cfg, data_cfg, dev) -> int:
    """Bulk predict of a force-field checkpoint: energies to the CSV, the
    per-atom forces to ``<out>.forces.npz`` (predict.py's force path)."""
    import time

    import numpy as np

    from cgnn_tpu_torch.data.graph import batch_iterator, batch_shape_key
    from cgnn_tpu_torch.train.force_step import make_force_predict_step
    from cgnn_tpu_torch.train.graphs import GraphCache, StepGraph
    from cgnn_tpu_torch.train.loop import batch_caps, edge_pack_fn

    try:
        graphs = _load_force(args, data_cfg.featurize_config())
    except (FileNotFoundError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2
    if any(g.positions is None for g in graphs):
        print("the force task needs geometry (positions, lattice, image "
              "offsets): this cache has none; refeaturize", file=sys.stderr)
        return 2
    layout_m = model_cfg.dense_m or None
    node_cap, edge_cap = batch_caps(graphs, args.batch_size, layout_m,
                                    None, None)
    step = make_force_predict_step()
    cache = GraphCache(lambda key, b: StepGraph(
        lambda x: step(state, x), b, device=dev, kind="predict",
        label=f"force predict graph {key}"), label="force predict graph")
    rows, ids, forces_out = [], [], []
    idx = n_batches = 0
    t0 = time.perf_counter()
    # the gathers' transpose rides in each batch (in_cap None): the forces
    # are a backward pass, summed in a fixed order
    for batch in batch_iterator(graphs, args.batch_size, node_cap, edge_cap,
                                dense_m=layout_m, snug=True,
                                pack_fn=edge_pack_fn(model_cfg.torch_dtype)):
        energies, forces = cache.run(batch_shape_key(batch), batch.to(dev))
        energies, forces = energies.cpu().numpy(), forces.cpu().numpy()
        node_graph = batch.node_graph.numpy()
        node_mask = batch.node_mask.numpy() > 0
        for k in range(int(batch.graph_mask.sum())):
            g = graphs[idx]
            rows.append([g.cif_id]
                        + [f"{t:.6f}" for t in np.atleast_1d(g.target)]
                        + [f"{energies[k]:.6f}"])
            ids.append(g.cif_id)
            forces_out.append(forces[(node_graph == k) & node_mask])
            idx += 1
        n_batches += 1
    rate = len(graphs) / (time.perf_counter() - t0)
    print(f"inference throughput: {rate:.0f} structures/sec (force field, "
          f"{n_batches} batches, {dev})")
    print("predict: " + json.dumps({
        "structures": len(graphs), "batches": n_batches,
        "structures_per_s": rate, "captures": cache.captures(),
        "replays": cache.replays()}, allow_nan=False))
    with open(args.out, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    print(f"wrote {len(rows)} predictions to {args.out}")
    np.savez(args.out + ".forces.npz", ids=np.array(ids),
             **{f"forces_{i}": a for i, a in enumerate(forces_out)})
    print(f"wrote per-atom forces to {args.out}.forces.npz")
    return 0

if __name__ == "__main__":
    sys.exit(main())
