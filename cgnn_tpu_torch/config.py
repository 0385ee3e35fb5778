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

``dtype='bfloat16'`` computes in bf16 with f32 parameters and statistics
(models/cgcnn.py); its edges are staged in bf16 (``edge_dtype``). On a
CUDA device every kernel its settings run has a bf16 instance (kernels
1-6). ``classification`` (a
``num_classes`` log-softmax head, ``dropout`` in train mode) and
``multi_task_head`` (models/heads.py) build anywhere.

``build_model(task='force')`` builds the force field instead
(``build_force_model``, models/forcefield.py): the same widths and
dtype, the edge featurization in the model, no BatchNorm.

``dense_m=0`` is the flat COO layout; there ``aggregation`` picks the
edge aggregation (ops/segment.py ``aggregate_edge_messages``: None or
``'xla'`` the library scatter-add, ``'sort'``, or ``'pallas'``, kernel 6
on CUDA tensors and its plain version on CPU tensors). The dense layout
does not read it.
"""

from __future__ import annotations

import dataclasses

import torch

from cgnn_tpu_torch.device import resolve_device

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype, which is also the edge features' storage
        dtype on every wire (train.py's ``edge_dtype``)."""
        if self.dtype not in TORCH_DTYPES:
            raise ValueError(f"dtype must be one of {sorted(TORCH_DTYPES)}, "
                             f"got {self.dtype!r}")
        return TORCH_DTYPES[self.dtype]

    @property
    def out_dim(self) -> int:
        """Columns of the model's output: ``num_classes`` log-probs for a
        classifier, else ``num_targets``."""
        return self.num_classes if self.classification else self.num_targets

    def for_arbitrary_inputs(self) -> "ModelConfig":
        """This config with data-derived bounds widened to always-correct
        settings, for inference entry points: ``cgconv_window=0``."""
        if not self.cgconv_impl or self.cgconv_window == 0:
            return self
        return dataclasses.replace(self, cgconv_window=0)

    def build(self, nbr_fea_len: int, device="cuda", dropout_seed: int = 0):
        """The model on ``device`` in eval mode (the caller puts it in
        ``.train()`` to train; raises when CUDA is asked for and absent).
        ``nbr_fea_len`` is the Gaussian edge width G
        (``DataConfig.nbr_fea_len``); ``dropout_seed`` seeds the dropout
        mask's generator."""
        from cgnn_tpu_torch.data.elements import ATOM_FEA_DIM
        from cgnn_tpu_torch.models.cgcnn import CrystalGraphConvNet

        dev = resolve_device(device)
        dtype = self.torch_dtype
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
            classification=self.classification,
            num_classes=self.num_classes,
            dropout=self.dropout,
            dtype=dtype,
            multi_task_head=self.multi_task_head,
            dropout_seed=dropout_seed,
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


# why the force task refuses the COO layout's kernel aggregation: the
# reference fails there (ROADMAP Queue 3), so the port has nothing to
# hold such a run to
FORCE_PALLAS_REFUSAL = (
    "--task force with --aggregation pallas: the JAX package's force step "
    "fails there (the outer derivative takes a JVP of kernel 6's "
    "custom-VJP forward, and pallas_call has no JVP rule: "
    "NotImplementedError from _pallas_call_jvp_rule), so the port refuses "
    "it too (ROADMAP Queue 3); use the dense layout or --aggregation xla")


def build_force_model(model_cfg: ModelConfig, data_cfg: DataConfig,
                      device="cuda"):
    """The force field (models/forcefield.py) for a config pair, in eval
    mode on ``device``, after ``cgnn_tpu/config.py``'s ``build_model``:
    the edge featurization in the model (``dmax`` the cutoff radius), the
    config's dtype, layout and COO aggregation. Refused, as the JAX
    package refuses them: ``fused_epilogue`` and ``cgconv_impl`` (they
    fuse BatchNorm, which the trunk lacks) and ``aggregation='pallas'``
    on COO (``FORCE_PALLAS_REFUSAL``)."""
    from cgnn_tpu_torch.data.elements import ATOM_FEA_DIM
    from cgnn_tpu_torch.models.forcefield import ForceFieldCGCNN

    if model_cfg.fused_epilogue or model_cfg.cgconv_impl:
        raise NotImplementedError(
            "the force task refuses fused_epilogue and cgconv_impl: both "
            "fuse the BN1 -> gate -> sum chain, and the force field's trunk "
            "has no BatchNorm")
    if not model_cfg.dense_m and model_cfg.aggregation == "pallas":
        raise NotImplementedError(FORCE_PALLAS_REFUSAL)
    dev = resolve_device(device)
    return ForceFieldCGCNN(
        orig_atom_fea_len=ATOM_FEA_DIM,
        atom_fea_len=model_cfg.atom_fea_len,
        n_conv=model_cfg.n_conv,
        h_fea_len=model_cfg.h_fea_len,
        dmin=data_cfg.dmin,
        dmax=data_cfg.radius,
        step=data_cfg.step,
        dtype=model_cfg.torch_dtype,
        aggregation_impl=model_cfg.aggregation,
        dense_m=model_cfg.dense_m or None,
    ).to(dev).eval()


def build_model(model_cfg: ModelConfig, data_cfg: DataConfig, device="cuda",
                task: str = "regression", dropout_seed: int = 0,
                graph_group=None):
    """The model for a (model, data) config pair and ``task`` on
    ``device``: regression and classification (the config says which),
    or the force field (``build_force_model``). ``graph_group`` (a
    ``parallel.dist.Group``; the JAX ``edge_axis_name``) shards every
    conv's edge work over its ranks (models/cgcnn.py
    ``set_graph_group``): a run-time choice, not part of the config, so a
    checkpoint restores into the unsharded model unchanged. The force
    task refuses it, as the JAX package does."""
    if task == "force":
        if graph_group is not None:
            raise NotImplementedError(
                "graph sharding is not supported for the force task")
        return build_force_model(model_cfg, data_cfg, device)
    if task not in ("regression", "classification"):
        raise ValueError(f"unknown task {task!r}")
    model = model_cfg.build(data_cfg.nbr_fea_len, device=device,
                            dropout_seed=dropout_seed)
    return model.set_graph_group(graph_group) if graph_group else model
