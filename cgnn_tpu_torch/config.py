"""Model and data configuration (``cgnn_tpu/config.py``).

The dataclasses are the checkpoint contract: ``to_meta``/``from_meta``
read and write the same flat dict the JAX package serializes, so a meta
written by either side rebuilds the same model on the other.

``cgconv_impl`` selects how each dense conv runs:

- ``'pallas'``: the whole-conv fused op; on CUDA tensors it launches the
  hand-written Hopper kernel (ops/fused_cgconv.py), on CPU tensors it
  runs that kernel's plain PyTorch version;
- ``'xla'``: the plain structured twin, on any device;
- ``''``: the unfused plain path (models/cgcnn.py).

``fused_epilogue`` (``'pallas'``/``'xla'``, exclusive with ``cgconv_impl``)
runs the unfused path's BN1 -> gate -> sum chain as one op
(ops/fused_epilogue.py): its kernels on CUDA tensors under ``'pallas'``,
their plain versions otherwise.

Unlike the JAX package, no setting quietly becomes another one on some
device: a CUDA tensor under ``'pallas'`` launches the kernel or raises.
``cgconv_window`` is kept for the meta round trip and ignored — the GPU
kernel gathers neighbor rows directly, with no window.

``dense_m=0`` is the flat COO layout; there ``aggregation`` picks the
edge aggregation (ops/segment.py ``aggregate_edge_messages``: None or
``'xla'`` the library scatter-add, ``'sort'``, or ``'pallas'``, kernel 6
on CUDA tensors and its plain version on CPU tensors). The dense layout
does not read it.
"""

from __future__ import annotations

import dataclasses

from cgnn_tpu_torch.device import resolve_device


@dataclasses.dataclass
class ModelConfig:
    atom_fea_len: int = 64
    n_conv: int = 3
    h_fea_len: int = 128
    n_h: int = 1
    num_targets: int = 1
    classification: bool = False
    num_classes: int = 2
    dropout: float = 0.0
    dtype: str = "float32"  # 'float32' | 'bfloat16'
    aggregation: str | None = None  # the COO aggregation; unused by dense
    multi_task_head: bool = False
    # dense edge-slot layout (data/graph.py pack_graphs dense_m); 0 = COO
    dense_m: int = 0
    fused_epilogue: str = ""
    cgconv_impl: str = ""  # '' | 'xla' | 'pallas' (module docstring)
    cgconv_window: int = 0  # kept in the meta; ignored by the GPU kernel

    def to_meta(self) -> dict:
        return dataclasses.asdict(self) | {
            "aggregation": self.aggregation or "__none__"
        }

    @classmethod
    def from_meta(cls, meta: dict) -> "ModelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in meta.items() if k in fields}
        kw["classification"] = bool(kw.get("classification", 0))
        kw["multi_task_head"] = bool(kw.get("multi_task_head", 0))
        kw["dense_m"] = int(kw.get("dense_m", 0))
        kw["fused_epilogue"] = str(kw.get("fused_epilogue", "") or "")
        kw["cgconv_impl"] = str(kw.get("cgconv_impl", "") or "")
        kw["cgconv_window"] = int(kw.get("cgconv_window", 0))
        if kw.get("aggregation") in ("__none__", None):
            kw["aggregation"] = None
        return cls(**kw)

    def for_arbitrary_inputs(self) -> "ModelConfig":
        """This config with data-derived bounds widened to always-correct
        settings, for inference entry points: ``cgconv_window=0``."""
        if not self.cgconv_impl or self.cgconv_window == 0:
            return self
        return dataclasses.replace(self, cgconv_window=0)

    def build(self, nbr_fea_len: int, device="cuda"):
        """The model on ``device`` in eval mode (the caller puts it in
        ``.train()`` to train; raises when CUDA is asked for and absent).
        ``nbr_fea_len`` is the Gaussian edge width G
        (``DataConfig.nbr_fea_len``)."""
        from cgnn_tpu_torch.data.elements import ATOM_FEA_DIM
        from cgnn_tpu_torch.models.cgcnn import CrystalGraphConvNet

        dev = resolve_device(device)
        unported = {
            "classification": self.classification,
            "multi_task_head": self.multi_task_head,
            "dtype='bfloat16'": self.dtype != "float32",
        }
        bad = [k for k, on in unported.items() if on]
        if bad:
            raise NotImplementedError(
                f"not ported yet: {', '.join(bad)}")
        return CrystalGraphConvNet(
            orig_atom_fea_len=ATOM_FEA_DIM,
            nbr_fea_len=nbr_fea_len,
            atom_fea_len=self.atom_fea_len,
            n_conv=self.n_conv,
            h_fea_len=self.h_fea_len,
            n_h=self.n_h,
            num_targets=self.num_targets,
            dense_m=self.dense_m or None,
            cgconv_impl=self.cgconv_impl,
            fused_epilogue=self.fused_epilogue,
            aggregation_impl=self.aggregation,
        ).to(dev).eval()


@dataclasses.dataclass
class DataConfig:
    radius: float = 8.0
    max_num_nbr: int = 12
    dmin: float = 0.0
    step: float = 0.2

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, meta: dict) -> "DataConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in meta.items() if k in fields})

    def featurize_config(self):
        from cgnn_tpu_torch.data.dataset import FeaturizeConfig

        return FeaturizeConfig(
            radius=self.radius,
            max_num_nbr=self.max_num_nbr,
            dmin=self.dmin,
            step=self.step,
        )

    @property
    def nbr_fea_len(self) -> int:
        """Edge feature width G of the Gaussian basis."""
        return self.featurize_config().gdf().num_features


def build_model(model_cfg: ModelConfig, data_cfg: DataConfig, device="cuda"):
    """The regression model for a (model, data) config pair on ``device``."""
    return model_cfg.build(data_cfg.nbr_fea_len, device=device)
