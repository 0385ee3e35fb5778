#!/usr/bin/env python
"""Carry a ``train.py`` checkpoint over to the PyTorch/CUDA port.

    python jax_checkpoint_to_torch.py JAX_CKPT_DIR PORT_CKPT_DIR [--best]
    python -m cgnn_tpu_torch.predict PORT_CKPT_DIR --synthetic 16

Reads a committed checkpoint of the JAX package (``cgnn_tpu.train``
``CheckpointManager``: its fallback chain and integrity manifests, the
tag ``latest`` or, with ``--best``, ``best``) through
``restore_for_inference``, with the template state built as
``predict.py`` builds it, and commits one checkpoint of the port
(``cgnn_tpu_torch.train.checkpoint``) into PORT_CKPT_DIR: the weights
(``params``, ``batch_stats``, already the port's portable layout,
``cgnn_tpu_torch/convert.py``), the normalizer, and the meta with its
``epoch`` and ``best_mae``. It carries no optimizer state, so the port's
predict and ``load_server`` read it and its ``--resume`` refuses it.

This script imports JAX by design and runs where the JAX package runs
(``--device cpu`` pins JAX to the CPU); nothing of the port imports it.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("jax_ckpt_dir", help="checkpoint directory of train.py")
    p.add_argument("port_ckpt_dir",
                   help="checkpoint directory of the port to commit into")
    p.add_argument("--best", action="store_true",
                   help="convert the best checkpoint instead of the latest")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="where JAX restores ('cpu' pins it to the CPU)")
    return p


def _host_tree(tree) -> dict:
    """A (frozen) dict of JAX arrays -> nested dicts of numpy arrays."""
    import numpy as np

    if hasattr(tree, "items"):
        return {str(k): _host_tree(v) for k, v in tree.items()}
    return np.array(tree)  # a copy, never a view of a device buffer


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from cgnn_tpu.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu.data.dataset import load_synthetic
    from cgnn_tpu.data.graph import batch_iterator, capacities_for
    from cgnn_tpu.train import (
        CheckpointManager,
        Normalizer,
        create_train_state,
        make_optimizer,
    )
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager as PortCkpt

    tag = "best" if args.best else "latest"
    src = CheckpointManager(args.jax_ckpt_dir)
    try:
        if not src.exists(tag):
            print(f"no '{tag}' checkpoint under {args.jax_ckpt_dir}",
                  file=sys.stderr)
            return 2
        meta = src.read_meta(tag)
        model_cfg = ModelConfig.from_meta(meta["model"])
        data_cfg = DataConfig.from_meta(meta["data"])
        model = build_model(model_cfg.for_arbitrary_inputs(), data_cfg,
                            meta.get("task", "regression"))
        # the template state, as predict.py builds it (restore_for_inference
        # reads the saved tree whole; the example only types the state)
        graphs = load_synthetic(2, data_cfg.featurize_config())
        layout_m = model_cfg.dense_m or None
        node_cap, edge_cap = capacities_for(graphs, 2, dense_m=layout_m,
                                            snug=True)
        example = next(batch_iterator(graphs, 2, node_cap, edge_cap,
                                      dense_m=layout_m, in_cap=0,
                                      snug=True))
        state = create_train_state(
            model, example, make_optimizer(),
            Normalizer.identity(model_cfg.num_targets),
            rng=jax.random.key(0))
        state = src.restore_for_inference(state, tag)
        restored = src.last_restored
    finally:
        src.close()
    tree = {
        "params": _host_tree(state.params),
        "batch_stats": _host_tree(state.batch_stats),
        "normalizer": {"mean": _host_tree(state.normalizer.mean),
                       "std": _host_tree(state.normalizer.std)},
    }
    port_meta = {k: meta[k] for k in ("model", "data", "task", "epoch",
                                      "best_mae") if k in meta}
    port_meta["converted_from"] = {
        "dir": os.path.abspath(args.jax_ckpt_dir), "save": restored}
    dst = PortCkpt(args.port_ckpt_dir, keep=0)
    try:
        dst.save_tree(tree, port_meta, is_best=True)
        dst.wait()
        name = dst.newest_committed()
    finally:
        dst.close()
    print(f"converted {args.jax_ckpt_dir} ({restored}, epoch "
          f"{meta.get('epoch')}) into {args.port_ckpt_dir}/{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
