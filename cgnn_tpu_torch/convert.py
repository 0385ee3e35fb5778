"""Weight carry between the JAX parameter tree and the port's modules.

The portable form is the JAX one: a nested dict of numpy arrays under
``params/...`` and ``batch_stats/...`` (what
``jax.tree_util.tree_map(np.asarray, variables)`` yields for a
``CrystalGraphConvNet``). On disk it is an ``.npz`` keyed by the
slash-joined paths plus a ``meta.json`` with the model and data configs
and the normalizer.

Layout rules: a Dense ``kernel`` [in, out] becomes ``nn.Linear.weight``
[out, in]; ``fc_full/kernel`` stays [2F+G, 2F], the layout the fused
kernel reads; BatchNorm ``scale`` becomes ``weight``, and the
``batch_stats`` ``mean``/``var`` become the ``running_mean``/
``running_var`` buffers.
"""

from __future__ import annotations

import json
import math
from collections import OrderedDict

import numpy as np
import torch

from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data.elements import ATOM_FEA_DIM


def flatten(variables: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """{"params/conv_0/fc_full/kernel": array, ...} from a nested dict."""
    out = {}
    for k, v in variables.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = out
        for mname in mods:
            node = node.setdefault(mname, {})
        node[leaf] = v
    return out


def from_flax_variables(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """The port model's ``state_dict`` from the JAX variables tree."""
    sd = OrderedDict()
    for path, v in flatten(variables).items():
        coll, *mods, leaf = path.split("/")
        mod = ".".join(mods)
        arr = np.asarray(v, np.float32)
        if coll == "params" and leaf == "kernel":
            if mods[-1] == "fc_full":
                sd[f"{mod}.kernel"] = arr
            else:
                sd[f"{mod}.weight"] = arr.T
        elif coll == "params" and leaf == "bias":
            sd[f"{mod}.bias"] = arr
        elif coll == "params" and leaf == "scale":
            sd[f"{mod}.weight"] = arr
        elif coll == "batch_stats" and leaf in ("mean", "var"):
            sd[f"{mod}.running_{leaf}"] = arr
        else:
            raise ValueError(f"no port counterpart for variable {path!r}")
    return OrderedDict(
        (k, torch.from_numpy(np.ascontiguousarray(a))) for k, a in sd.items())


def to_flax_variables(state_dict) -> dict:
    """The inverse of ``from_flax_variables`` (numpy leaves)."""
    flat = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy().astype(np.float32)
        mod, leaf = key.rsplit(".", 1)
        path = mod.replace(".", "/")
        if leaf == "kernel":
            flat[f"params/{path}/kernel"] = arr
        elif leaf == "weight":
            flat[f"params/{path}/" + ("kernel" if arr.ndim == 2
                                      else "scale")] = (
                arr.T if arr.ndim == 2 else arr)
        elif leaf == "bias":
            flat[f"params/{path}/bias"] = arr
        elif leaf in ("running_mean", "running_var"):
            flat[f"batch_stats/{path}/{leaf[len('running_'):]}"] = arr
        else:
            raise ValueError(f"no JAX counterpart for {key!r}")
    return unflatten(flat)


def save_params(params_npz: str, meta_json: str, variables: dict,
                model_cfg: ModelConfig, data_cfg: DataConfig,
                normalizer_mean=(0.0,), normalizer_std=(1.0,)) -> None:
    """Write the JAX-layout ``variables`` and the meta beside them."""
    np.savez(params_npz, **flatten(variables))
    meta = {
        "model": model_cfg.to_meta(),
        "data": data_cfg.to_meta(),
        "normalizer": {
            "mean": [float(x) for x in np.asarray(normalizer_mean, np.float32)],
            "std": [float(x) for x in np.asarray(normalizer_std, np.float32)],
        },
    }
    with open(meta_json, "w") as f:
        json.dump(meta, f, indent=1, allow_nan=False)


def load_params(params_npz: str, meta_json: str) -> tuple[dict, dict]:
    """-> (JAX-layout variables as numpy, meta dict)."""
    with np.load(params_npz) as z:
        variables = unflatten({k: z[k] for k in z.files})
    with open(meta_json) as f:
        meta = json.load(f)
    return variables, meta


def _lecun_normal(rng: np.random.Generator, fan_in: int,
                  shape: tuple) -> np.ndarray:
    """flax's lecun_normal: a normal truncated to [-2, 2] std units,
    rescaled so the result has variance 1/fan_in."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return (x * std).astype(np.float32)


def init_params(model_cfg: ModelConfig, data_cfg: DataConfig,
                seed: int = 0) -> dict:
    """Random JAX-layout variables from a numpy seed: lecun-normal
    kernels, zero biases, unit BN scales, running stats (0, 1)."""
    rng = np.random.default_rng(seed)
    f, h = model_cfg.atom_fea_len, model_cfg.h_fea_len
    g = data_cfg.nbr_fea_len

    def dense(n_in, n_out):
        return {"kernel": _lecun_normal(rng, n_in, (n_in, n_out)),
                "bias": np.zeros(n_out, np.float32)}

    def bn(c):
        return ({"scale": np.ones(c, np.float32),
                 "bias": np.zeros(c, np.float32)},
                {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32)})

    params: dict = {"embedding": dense(ATOM_FEA_DIM, f)}
    stats: dict = {}
    for i in range(model_cfg.n_conv):
        bn1, bn1_s = bn(2 * f)
        bn2, bn2_s = bn(f)
        params[f"conv_{i}"] = {"fc_full": dense(2 * f + g, 2 * f),
                               "bn1": bn1, "bn2": bn2}
        stats[f"conv_{i}"] = {"bn1": bn1_s, "bn2": bn2_s}
    params["conv_to_fc"] = dense(f, h)
    for i in range(model_cfg.n_h - 1):
        params[f"fc_{i}"] = dense(h, h)
    params["fc_out"] = dense(h, model_cfg.num_targets)
    return {"params": params, "batch_stats": stats}
