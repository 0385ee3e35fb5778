"""Train the CGCNN regression model with the port:

    python -m cgnn_tpu_torch.train --synthetic 400 --epochs 30
    python -m cgnn_tpu_torch.train --device cpu --synthetic 40 --epochs 1

The flags are train.py's that this entry point serves, with train.py's
defaults. It runs on the CUDA card unless ``--device cpu`` asks for the
CPU (where the kernels' plain versions run); without a card the default
raises. At the end it writes ``params.npz`` + ``meta.json`` to
``--out-dir`` (the JAX layout, convert.save_params), which ``load_server``
serves, and prints the test-split MAE.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cgnn_tpu_torch.train",
        description="Train CGCNN (regression) with the PyTorch/CUDA port.")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N synthetic crystals (required: the "
                        "port reads no CIF directory yet)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--lr", "--learning-rate", type=float, default=0.01,
                   dest="lr")
    p.add_argument("--lr-milestones", type=int, nargs="*", default=[100],
                   help="epochs at which the lr is multiplied by 0.1")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--optim", choices=["SGD", "Adam", "AdamW"], default="SGD")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--train-ratio", type=float, default=0.8)
    p.add_argument("--val-ratio", type=float, default=0.1)
    p.add_argument("--atom-fea-len", type=int, default=64)
    p.add_argument("--h-fea-len", type=int, default=128)
    p.add_argument("--n-conv", type=int, default=3)
    p.add_argument("--n-h", type=int, default=1)
    p.add_argument("--max-num-nbr", type=int, default=12)
    p.add_argument("--radius", type=float, default=8.0)
    p.add_argument("--dmin", type=float, default=0.0)
    p.add_argument("--step", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--packing", choices=["snug"], default="snug",
                   help="fill-to-capacity batches (the only packing ported)")
    p.add_argument("--cgconv-impl", choices=["off", "xla", "pallas"],
                   default="off",
                   help="whole-conv fused op; 'pallas' runs the CUDA "
                        "kernels on the card")
    p.add_argument("--fused-epilogue", choices=["off", "xla", "pallas"],
                   default="off",
                   help="fused BN1->gate->sum op; 'pallas' runs the CUDA "
                        "kernels on the card")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--out-dir", default="checkpoints/torch",
                   help="where params.npz and meta.json are written")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cgconv_impl != "off" and args.fused_epilogue != "off":
        print("--cgconv-impl (the whole-conv fused kernel) subsumes "
              "--fused-epilogue; pick one", file=sys.stderr)
        return 2
    if args.synthetic <= 0:
        print("--synthetic N is required", file=sys.stderr)
        return 2

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        train_val_test_split,
    )
    from cgnn_tpu_torch.device import resolve_device
    from cgnn_tpu_torch.train.loop import evaluate, fit
    from cgnn_tpu_torch.train.state import init_train_state

    dev = resolve_device(args.device)
    data_cfg = DataConfig(radius=args.radius, max_num_nbr=args.max_num_nbr,
                          dmin=args.dmin, step=args.step)
    t0 = time.perf_counter()
    graphs = load_synthetic(args.synthetic, data_cfg.featurize_config(),
                            seed=args.seed)
    print(f"featurized {len(graphs)} structures "
          f"in {time.perf_counter() - t0:.1f}s")
    train_g, val_g, test_g = train_val_test_split(
        graphs, args.train_ratio, args.val_ratio, seed=args.seed)
    num_targets = int(train_g[0].target.shape[0])
    dense_m = args.max_num_nbr
    model_cfg = ModelConfig(
        atom_fea_len=args.atom_fea_len, n_conv=args.n_conv,
        h_fea_len=args.h_fea_len, n_h=args.n_h, num_targets=num_targets,
        dense_m=dense_m,
        fused_epilogue="" if args.fused_epilogue == "off"
        else args.fused_epilogue,
        cgconv_impl="" if args.cgconv_impl == "off" else args.cgconv_impl,
    )
    state, node_cap = init_train_state(
        model_cfg, data_cfg, train_g, batch_size=args.batch_size, device=dev,
        seed=args.seed, optim=args.optim, lr=args.lr,
        momentum=args.momentum, weight_decay=args.weight_decay,
        lr_milestones_epochs=args.lr_milestones)
    state, result = fit(
        state, train_g, val_g, epochs=args.epochs,
        batch_size=args.batch_size, dense_m=dense_m, device=dev,
        node_cap=node_cap, seed=args.seed, print_freq=args.print_freq)
    test_m = evaluate(state, test_g, args.batch_size, node_cap, dense_m,
                      dev)
    print(f"** test mae: {test_m.get('mae', float('nan')):.4f} "
          f"(best val: {result['best']:.4f})")
    os.makedirs(args.out_dir, exist_ok=True)
    npz = os.path.join(args.out_dir, "params.npz")
    meta = os.path.join(args.out_dir, "meta.json")
    convert.save_params(
        npz, meta, convert.to_flax_variables(state.model.state_dict()),
        model_cfg, data_cfg,
        normalizer_mean=state.normalizer.mean.cpu().numpy(),
        normalizer_std=state.normalizer.std.cpu().numpy())
    print(f"wrote {npz} and {meta}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
