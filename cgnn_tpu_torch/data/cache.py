"""On-disk graph cache: featurize once, then load tensors
(``cgnn_tpu/data/cache.py``).

    CIFs --(featurize, parallel, once)--> cache file --(mmap)--> batcher

Format: one ``.npz`` holding the concatenation of all per-graph arrays plus
their node and edge counts, version 1 — the JAX package's format, so each
stack reads the other's caches. Graphs load as views into the mmap'd
arrays. Featurization runs in worker processes started by ``spawn``:
forking a process that holds torch's threads (or a CUDA context) is
unsafe. A worker imports only the numpy modules its job needs
(``featurize.featurize_cif_job``), never torch.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Sequence

import numpy as np

from cgnn_tpu_torch.data.dataset import read_id_prop
from cgnn_tpu_torch.data.featurize import featurize_cif_job
from cgnn_tpu_torch.data.graph import CrystalGraph

_VERSION = 1


def save_graph_cache(graphs: Sequence[CrystalGraph], path: str) -> None:
    """Serialize featurized graphs into one npz (written to ``path.tmp``,
    then renamed over ``path``)."""
    node_counts = np.array([g.num_nodes for g in graphs], np.int64)
    edge_counts = np.array([g.num_edges for g in graphs], np.int64)
    tgt = [np.atleast_1d(np.asarray(g.target, np.float32)) for g in graphs]
    tdim = max(len(t) for t in tgt)
    targets = np.zeros((len(graphs), tdim), np.float32)
    target_mask = np.zeros((len(graphs), tdim), np.float32)
    for i, (g, t) in enumerate(zip(graphs, tgt)):
        targets[i, : len(t)] = t
        if g.target_mask is not None:
            target_mask[i, : len(t)] = np.atleast_1d(g.target_mask)
        else:
            target_mask[i, : len(t)] = 1.0

    have_geom = all(
        g.positions is not None and g.lattice is not None
        and g.offsets is not None
        for g in graphs
    )
    payload = {
        "version": np.int64(_VERSION),
        "node_counts": node_counts,
        "edge_counts": edge_counts,
        "atom_fea": np.concatenate([g.atom_fea for g in graphs]),
        "edge_fea": np.concatenate([g.edge_fea for g in graphs]),
        "centers": np.concatenate([g.centers for g in graphs]),
        "neighbors": np.concatenate([g.neighbors for g in graphs]),
        "targets": targets,
        "target_mask": target_mask,
        "cif_ids": np.array([g.cif_id for g in graphs]),
        "has_geometry": np.int64(1 if have_geom else 0),
    }
    if all(g.distances is not None for g in graphs):
        payload["distances"] = np.concatenate([g.distances for g in graphs])
    if have_geom:
        payload["positions"] = np.concatenate([g.positions for g in graphs])
        payload["lattices"] = np.stack([g.lattice for g in graphs])
        payload["offsets"] = np.concatenate([g.offsets for g in graphs])
    if all(g.forces is not None for g in graphs):
        payload["forces"] = np.concatenate([g.forces for g in graphs])
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_graph_cache(path: str) -> list[CrystalGraph]:
    """Load a cache back into CrystalGraphs (views into the mmap'd
    arrays), with the per-atom force labels where the cache holds them."""
    z = np.load(path, mmap_mode="r", allow_pickle=False)
    if int(z["version"]) != _VERSION:
        raise ValueError(
            f"cache {path} has version {int(z['version'])}, expected "
            f"{_VERSION}")
    node_counts = np.asarray(z["node_counts"])
    edge_counts = np.asarray(z["edge_counts"])
    node_off = np.concatenate([[0], np.cumsum(node_counts)])
    edge_off = np.concatenate([[0], np.cumsum(edge_counts)])
    atom_fea = z["atom_fea"]
    edge_fea = z["edge_fea"]
    centers = z["centers"]
    neighbors = z["neighbors"]
    targets = np.asarray(z["targets"])
    target_mask = np.asarray(z["target_mask"])
    cif_ids = np.asarray(z["cif_ids"])
    has_geom = bool(int(z["has_geometry"]))
    distances = z["distances"] if "distances" in z else None
    forces = z["forces"] if "forces" in z else None
    graphs = []
    for i in range(len(node_counts)):
        ns = slice(node_off[i], node_off[i + 1])
        ne = slice(edge_off[i], edge_off[i + 1])
        graphs.append(CrystalGraph(
            atom_fea=atom_fea[ns],
            edge_fea=edge_fea[ne],
            centers=np.asarray(centers[ne]),
            neighbors=np.asarray(neighbors[ne]),
            target=targets[i],
            cif_id=str(cif_ids[i]),
            target_mask=target_mask[i],
            distances=None if distances is None else distances[ne],
            positions=z["positions"][ns] if has_geom else None,
            lattice=np.asarray(z["lattices"][i]) if has_geom else None,
            offsets=z["offsets"][ne] if has_geom else None,
            forces=None if forces is None else forces[ns],
        ))
    return graphs


def featurize_directory_parallel(
    root_dir: str,
    cfg,
    workers: int | None = None,
    id_prop_file: str = "id_prop.csv",
    keep_geometry: bool = False,
) -> tuple[list[CrystalGraph], list[tuple[str, str]]]:
    """CIF directory -> (graphs, failures), both in id_prop.csv order.

    ``workers`` processes (default: every core; 1 runs on this thread)
    parse and featurize the files; a failure is ``(cif_id, message)``.
    """
    workers = workers or os.cpu_count() or 1
    grid = (cfg.radius, cfg.max_num_nbr, cfg.dmin, cfg.step)
    jobs = [(path, cif_id, target, mask, grid, keep_geometry)
            for cif_id, path, target, mask in read_id_prop(root_dir,
                                                           id_prop_file)]
    graphs: list[CrystalGraph] = []
    failures: list[tuple[str, str]] = []

    def consume(results) -> None:
        for r in results:
            if isinstance(r, dict):
                graphs.append(CrystalGraph(**r))
            else:
                failures.append(r)

    if workers <= 1:
        consume(map(featurize_cif_job, jobs))
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            consume(pool.map(featurize_cif_job, jobs,
                             chunksize=max(1, min(32, len(jobs)
                                                  // (4 * workers)))))
    return graphs, failures
