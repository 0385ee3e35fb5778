"""Featurize a CIF directory into a graph cache, once:

    python -m cgnn_tpu_torch.data.preprocess DATA_DIR -o graphs.npz [-j N]

``python -m cgnn_tpu.data.preprocess``'s flags and cache format (version 1,
data/cache.py): either stack reads the other's caches. The train and
predict entry points read the cache through ``--cache``. The neighbor
search is the native cell list where g++ is on PATH, else numpy (the
same arrays either way; data/neighbors.py): the last line names it.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cgnn_tpu_torch.data.preprocess",
        description="CIF directory -> graph cache (.npz)")
    p.add_argument("root_dir")
    p.add_argument("-o", "--out", required=True, help="output .npz cache path")
    p.add_argument("-j", "--workers", type=int, default=0,
                   help="worker processes (0 = all cores)")
    p.add_argument("--radius", type=float, default=8.0)
    p.add_argument("--max-num-nbr", type=int, default=12)
    p.add_argument("--dmin", type=float, default=0.0)
    p.add_argument("--step", type=float, default=0.2)
    p.add_argument("--keep-geometry", action="store_true",
                   help="store positions, lattices and image offsets")
    args = p.parse_args(argv)

    from cgnn_tpu_torch import native
    from cgnn_tpu_torch.data.cache import (
        featurize_directory_parallel,
        save_graph_cache,
    )
    from cgnn_tpu_torch.data.dataset import FeaturizeConfig

    cfg = FeaturizeConfig(radius=args.radius, max_num_nbr=args.max_num_nbr,
                          dmin=args.dmin, step=args.step)
    t0 = time.perf_counter()
    backend = native.resolve("auto")
    graphs, failures = featurize_directory_parallel(
        args.root_dir, cfg, workers=args.workers or None,
        keep_geometry=args.keep_geometry)
    dt = time.perf_counter() - t0
    for cif_id, err in failures[:20]:
        print(f"skipped {cif_id}: {err}", file=sys.stderr)
    if len(failures) > 20:
        print(f"... and {len(failures) - 20} more failures", file=sys.stderr)
    if not graphs:
        print("no usable structures", file=sys.stderr)
        return 1
    save_graph_cache(graphs, args.out)
    print(f"featurized {len(graphs)} structures in {dt:.1f}s "
          f"({len(graphs) / max(dt, 1e-9):.0f} structs/s) -> {args.out} "
          f"(neighbor search: {backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
