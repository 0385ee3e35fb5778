"""Whole-conv fused CGConv (``cgnn_tpu/ops/pallas_cgconv.py``).

gather -> fc_full -> BN1 -> sigmoid*softplus gate -> masked sum over the M
edge slots, as one op that writes only the [N, F] aggregate.

- ``fused_cgconv_eval`` (eval/serving): ONE apply pass with the running
  statistics — kernel 1 (``fused_cgconv_eval_cuda``): a node pass writes
  the per-node projections P = nodes·[W_i | W_j] + [b | 0] to scratch,
  then a slot pass adds e·W_e per real slot, with W_e in registers.
- ``fused_cgconv`` (training), an autograd Function with the JAX
  signature and outputs ``(agg, mean, var, n_real)``. Its ``'pallas'``
  forward is the JAX ``_forward_pallas``: the cancellation shift in plain
  torch, the stats pass — kernel 2 (``fused_cgconv_stats_cuda``) — then
  the moments in torch, then the apply pass (kernel 1) with the batch
  statistics. Both passes take z factored the same way, so on the card
  one node pass (``fused_cgconv_node_cuda``) writes P once per conv and
  both slot passes read it (``p=``). Its backward rematerializes z from
  the saved inputs with
  plain torch matmuls, takes the BN1 -> gate -> sum backward through
  kernels 4 and 5 of ops/fused_epilogue.py, and carries dz back through
  the split fc_full: dW and db by matmuls, d_edges = dz W_e^T, d_nodes =
  (sum over M of dz) W_i^T plus the gather's transpose of dz W_j^T
  (ops/segment.py). The JAX package takes the same backward by
  ``jax.vjp`` of its structured forward; the port computes the same
  function through kernels 4-5, which puts the JAX package's hand backward
  of that chain on the flagship training path. The stats outputs get no
  gradient. ``'xla'`` is the plain structured twin on any device, with
  autograd for the backward.

Every kernel wrapper takes CUDA tensors only, checks them, launches on the
current stream, raises on a refused launch, and counts its launches in
``<wrapper>.launches`` (none while a CUDA graph is captured:
``_build.counted``).

bf16 compute (``dtype=torch.bfloat16``): nodes and edges arrive in bf16,
and on the card go straight to the bf16 instances of kernels 1 and 2
(``fused_cgconv_node_bf16_cuda``, ``fused_cgconv_eval_bf16_cuda``,
``fused_cgconv_stats_bf16_cuda``), which widen them on load and compute
what the f32 instances compute on the widened values, as the TPU kernel
does (pallas_cgconv.py ``_z_block``); no f32 copy of either is made. The
weights and BN vectors stay f32 (the TPU kernel's ``cst``). The plain
version of a bf16 instance is therefore the f32 plain version on
``x.float()``. The training backward rematerializes z in bf16 and runs
the bf16 instances of kernels 4 and 5. A bf16 input on the card under
``'pallas'`` never runs in f32 or in a plain version: a mix of storage
types, or one without an instance, raises. ``impl='pallas'`` runs a kernel for a tensor that is
not on the CPU (launch or raise, never a fallback) and the kernel's plain
PyTorch version (``*_reference``) for a CPU tensor. ``window`` is accepted
and ignored: the GPU gathers neighbor rows directly.

Numerical contract: the dense CGConv branch in models/cgcnn.py, to f32
roundoff. Padding slots are selected to 0, never multiplied.
"""

from __future__ import annotations

import torch
from torch import nn

from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.ops.fused_epilogue import (
    check_impl,
    epilogue_backward,
    masked_stats,
    pack_cst,
    runs_kernel,
    softplus,
)
from cgnn_tpu_torch.ops.segment import (
    gather,
    gather_transpose,
    transpose_cotangent,
)

# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _z_structured(nodes, edges, kernel, bias, neighbors, dtype,
                  transpose=None):
    """fc_full(v_i, v_j, e) without materializing the concat; the v_j
    gather goes through ``gather_transpose`` when the batch carries the
    transpose mapping ``(in_slots, in_mask, over_slots, over_nodes,
    over_mask)``."""
    n, m = edges.shape[0], edges.shape[1]
    f = nodes.shape[-1]
    k = kernel.to(dtype)
    if transpose is not None:
        v_j = gather_transpose(nodes, neighbors.reshape(-1), *transpose)
    else:
        v_j = gather(nodes, neighbors.reshape(-1))
    v_j = v_j.reshape(n, m, f)
    z = (
        (nodes.to(dtype) @ k[:f])[:, None, :]
        + v_j.to(dtype) @ k[f: 2 * f]
        + edges.to(dtype) @ k[2 * f:]
    )
    return z + bias.to(dtype)


def _gate_sum(y, mask):
    """sigmoid(gate) * softplus(core), padding slots SELECTED to 0, summed
    over M."""
    f = y.shape[-1] // 2
    msg = torch.sigmoid(y[..., :f]) * softplus(y[..., f:])
    keep = (mask > 0)[..., None]
    return torch.where(keep, msg, msg.new_zeros(())).sum(dim=1)


def fused_cgconv_eval_reference(nodes, edges, kernel, bias, scale, bn_bias,
                                neighbors, edge_mask, mean, var, *,
                                eps: float = 1e-5, dtype=torch.float32):
    """Kernel 1's plain version (the JAX ``impl='xla'`` eval pass; with
    ``dtype`` f32 on bf16 inputs, the plain version of the bf16
    instance: the f32 pass on the widened values)."""
    n, m = edges.shape[0], edges.shape[1]
    rstd = torch.rsqrt(var.float() + eps)
    z = _z_structured(nodes, edges, kernel, bias, neighbors, dtype)
    y = (z.float() - mean.float()) * (rstd * scale) + bn_bias
    return _gate_sum(y, edge_mask.reshape(n, m).float())


def fused_cgconv_stats_reference(nodes, edges, kernel, bias, neighbors,
                                 edge_mask, shift, *, dtype=torch.float32):
    """Kernel 2's plain version -> [2, 2F] f32: over the real slots, the
    sums of (z - shift) and (z - shift)^2."""
    n, m = edges.shape[0], edges.shape[1]
    z = _z_structured(nodes, edges, kernel, bias, neighbors, dtype).float()
    keep = (edge_mask.reshape(n, m) > 0)[..., None]
    zm = torch.where(keep, z - shift, z.new_zeros(()))
    return torch.stack([zm.sum(dim=(0, 1)), (zm * zm).sum(dim=(0, 1))])


def node_projections_reference(nodes, kernel, bias, *,
                               dtype=torch.float32):
    """The node pass's plain version -> P [N, 4F] f32 = nodes .
    [W[0:F] | W[F:2F]] + [b | 0]: per node, its z terms as a center and as
    a neighbor."""
    f = nodes.shape[-1]
    k = kernel.to(dtype)
    v = nodes.to(dtype)
    return torch.cat([v @ k[:f] + bias.to(dtype), v @ k[f: 2 * f]],
                     dim=-1).float()


def stats_from_projections_reference(p, edges, kernel, neighbors, edge_mask,
                                     shift, *, dtype=torch.float32):
    """The stats slot pass's plain version -> [2, 2F] f32: z = P[i, 0:2F]
    + P[j, 2F:4F] + e . W_e per slot, then over the real slots the sums of
    (z - shift) and (z - shift)^2 (padding slots selected to 0)."""
    n, m = edges.shape[0], edges.shape[1]
    two_f = kernel.shape[1]
    p_j = p.index_select(0, neighbors.reshape(-1).long())[:, two_f:]
    z = (p[:, None, :two_f] + p_j.reshape(n, m, two_f)
         + (edges.to(dtype) @ kernel.to(dtype)[two_f:]).float())
    keep = (edge_mask.reshape(n, m) > 0)[..., None]
    zm = torch.where(keep, z - shift, z.new_zeros(()))
    return torch.stack([zm.sum(dim=(0, 1)), (zm * zm).sum(dim=(0, 1))])


def _forward_structured(nodes, edges, kernel, bias, scale, bn_bias,
                        neighbors, edge_mask, transpose, eps, dtype):
    """The structured twin of the training forward (``impl='xla'``)."""
    z = _z_structured(nodes, edges, kernel, bias, neighbors, dtype,
                      transpose)
    mean, var, n_real = masked_stats(z, edge_mask)
    rstd = torch.rsqrt(var + eps)
    y = (z.float() - mean) * (rstd * scale) + bn_bias
    agg = _gate_sum(y, edge_mask.float())
    return agg, mean, var, n_real


def _shift_row0(nodes, edges, kernel, bias, neighbors, dtype):
    """The stats estimator's cancellation shift: z of node row 0 averaged
    over its M slots, in plain torch (the JAX package computes it in jnp
    for the kernel to read as a constant)."""
    m = edges.shape[1]
    f = nodes.shape[-1]
    k = kernel.to(dtype)
    vj0 = nodes.index_select(0, neighbors.reshape(-1)[:m]).to(dtype)
    z0 = (nodes[0].to(dtype) @ k[:f] + vj0 @ k[f: 2 * f]
          + edges[0].to(dtype) @ k[2 * f:] + bias.to(dtype))
    return z0.float().mean(dim=0)


# ---------------------------------------------------------------------------
# the Hopper kernels (csrc/fused_cgconv.cu)
# ---------------------------------------------------------------------------

# the storage types of nodes and edges the kernels have instances for, by
# the suffix of their entry points
INSTANCES = {torch.float32: "f32", torch.bfloat16: "bf16"}

_SMEM_LIMIT = 232448  # bytes of shared memory one block may opt into
SLOT_PASS_MAX_F = 256  # kernel 1's slot pass: one thread a channel pair
W_E_REGISTER_MAX_G = 44  # kernel 1's slot pass keeps W_e in registers up
                         # to this G (kRegG), else in shared memory
STATS_TILE_SLOTS = 64  # kernel 2's slot pass: slots a tile (kStatsTileSlots)
STATS_BLOCKS = 264  # ... and at most this many blocks walk the tiles (two
                    # an SM of an H100's 132): one [2, 2F] partial each


def _stats_smem_bytes(g: int) -> int:
    """Kernel 2's slot pass's dynamic shared memory: W_e's columns [G4,
    128], two staged tiles of 64 edge rows (padded), neighbors and mask,
    at least the [2, 16, 128] block sum
    (``cgconv_fused_stats_smem_bytes`` in the CUDA source)."""
    g4 = -(-g // 4) * 4
    stride = g4 if g4 % 8 else g4 + 4
    return 4 * max(g4 * 128 + 2 * STATS_TILE_SLOTS * (stride + 2),
                   2 * 16 * 128)


_NOT_VECTORS = frozenset(("nodes", "edges", "kernel", "neighbors",
                          "edge_mask"))


def _check_conv_args(name: str, args: dict,
                     storage=torch.float32) -> tuple:
    """Device, dtype, contiguity and shape checks shared by the kernel
    wrappers. ``args`` holds nodes, edges, kernel, neighbors, edge_mask and
    [2F] vectors by name; nodes and edges must be of the instance's
    ``storage`` type, neighbors int32, the rest f32; -> (N, M, F, G).
    Devices are compared by index (``get_device``, an int, where
    ``.device`` builds an object a tensor); a message is formatted only
    for a fault."""
    nodes, edges = args["nodes"], args["edges"]
    dev = nodes.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    index = nodes.get_device()
    for key, t in args.items():
        if t.get_device() != index:
            raise ValueError(f"{key} is on {t.device}, nodes on {dev}")
        want = (torch.int32 if key == "neighbors"
                else storage if key in ("nodes", "edges")
                else torch.float32)
        if t.dtype != want:
            raise ValueError(f"{key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    if nodes.dim() != 2 or edges.dim() != 3:
        raise ValueError(
            f"nodes must be [N, F] and edges [N, M, G], got "
            f"{tuple(nodes.shape)} and {tuple(edges.shape)}")
    n, f = nodes.shape
    m, g = edges.shape[1], edges.shape[2]
    if edges.shape[0] != n:
        raise ValueError(
            f"edges must be [{n}, M, G], got {tuple(edges.shape)}")
    for key in ("neighbors", "edge_mask"):
        if args[key].numel() != n * m:
            raise ValueError(f"{key} must be {n * m} entries, got "
                             f"{tuple(args[key].shape)}")
    if args["kernel"].shape != (2 * f + g, 2 * f):
        raise ValueError(f"kernel must be [{2 * f + g}, {2 * f}], got "
                         f"{tuple(args['kernel'].shape)}")
    for key, t in args.items():
        if key not in _NOT_VECTORS and t.shape != (2 * f,):
            raise ValueError(
                f"{key} must be [{2 * f}], got {tuple(t.shape)}")
    return n, m, f, g


def _check_p(p, n: int, f: int, nodes) -> None:
    """A node pass's P handed to a slot pass: [N, 4F] f32, contiguous, on
    nodes' card."""
    if p.get_device() != nodes.get_device():
        raise ValueError(f"p is on {p.device}, nodes on {nodes.device}")
    if p.dtype != torch.float32 or not p.is_contiguous():
        raise ValueError("p must be contiguous torch.float32")
    if p.shape != (n, 4 * f):
        raise ValueError(f"p must be [{n}, {4 * f}], got {tuple(p.shape)}")


def _node_pass(name: str, storage, nodes, kernel, bias):
    """Launch the node pass of ``storage``'s instance -> P."""
    dev = nodes.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    for key, t in (("nodes", nodes), ("kernel", kernel), ("bias", bias)):
        if t.get_device() != nodes.get_device():
            raise ValueError(f"{key} is on {t.device}, nodes on {dev}")
        want = storage if key == "nodes" else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous {want}, got "
                             f"{t.dtype}")
    n, f = nodes.shape
    if kernel.dim() != 2 or kernel.shape[1] != 2 * f \
            or kernel.shape[0] <= 2 * f or bias.shape != (2 * f,):
        raise ValueError(
            f"kernel must be [2F+G, {2 * f}] and bias [{2 * f}], got "
            f"{tuple(kernel.shape)} and {tuple(bias.shape)}")
    p = torch.empty((n, 4 * f), dtype=torch.float32, device=dev)
    if n == 0:
        return p
    _build.launch(
        name,
        _build.entry("fused_cgconv",
                     f"cgconv_fused_node_{INSTANCES[storage]}", 4, 2),
        (nodes.data_ptr(), kernel.data_ptr(), bias.data_ptr(), p.data_ptr()),
        {"N": n, "F": f}, dev)
    NODE_CUDA[storage].launches += _build.counted(1)
    return p


def fused_cgconv_node_cuda(nodes, kernel, bias):
    """Kernel 1's node pass alone (launch 1a, which is also kernel 2's
    launch 2a) -> P [N, 4F] f32 = nodes . [W[0:F] | W[F:2F]] + [b | 0],
    for the training forward to hand to both slot passes (``p=``). nodes
    [N, F], kernel [2F+G, 2F], bias [2F]: f32, contiguous, on one CUDA
    device. ``.launches`` counts every node pass, also those that
    ``fused_cgconv_eval_cuda`` and ``fused_cgconv_stats_cuda`` run
    themselves when given no P."""
    return _node_pass("fused_cgconv_node_cuda", torch.float32, nodes,
                      kernel, bias)


def fused_cgconv_node_bf16_cuda(nodes, kernel, bias):
    """The bf16 instance of ``fused_cgconv_node_cuda``: nodes bf16, kernel
    and bias f32 -> P [N, 4F] f32 (module docstring); ``.launches`` as
    there, for the bf16 instances."""
    return _node_pass("fused_cgconv_node_bf16_cuda", torch.bfloat16, nodes,
                      kernel, bias)


fused_cgconv_node_cuda.launches = 0
fused_cgconv_node_bf16_cuda.launches = 0
NODE_CUDA = {torch.float32: fused_cgconv_node_cuda,
             torch.bfloat16: fused_cgconv_node_bf16_cuda}


def _eval_pass(name: str, storage, nodes, edges, kernel, bias, scale,
               bn_bias, neighbors, edge_mask, mean, var, eps, p):
    args = dict(nodes=nodes, edges=edges, kernel=kernel, bias=bias,
                scale=scale, bn_bias=bn_bias, neighbors=neighbors,
                edge_mask=edge_mask, mean=mean, var=var)
    n, m, f, g = _check_conv_args(name, args, storage)
    if f > SLOT_PASS_MAX_F:
        raise ValueError(f"F={f} exceeds the slot pass's "
                         f"{SLOT_PASS_MAX_F} threads per row")
    if 4 * g * 2 * f > _SMEM_LIMIT:
        raise ValueError(
            f"F={f}, G={g}: W_e [{g}, {2 * f}] does not fit one block's "
            f"shared memory ({4 * g * 2 * f} > {_SMEM_LIMIT} bytes)")
    out = torch.empty((n, f), dtype=torch.float32, device=nodes.device)
    if n == 0:
        return out
    node_pass = p is None
    if node_pass:
        p = torch.empty((n, 4 * f), dtype=torch.float32,
                        device=nodes.device)
    else:
        _check_p(p, n, f, nodes)
    _build.launch(
        name,
        _build.entry("fused_cgconv",
                     f"cgconv_fused_eval_{INSTANCES[storage]}", 12, 5, 1),
        (nodes.data_ptr(), edges.data_ptr(), neighbors.data_ptr(),
         edge_mask.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
         mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
         bn_bias.data_ptr(), p.data_ptr(), out.data_ptr()),
        {"N": n, "M": m, "F": f, "G": g, "node_pass": int(node_pass),
         "eps": eps}, nodes.device)
    EVAL_CUDA[storage].launches += _build.counted(1)
    NODE_CUDA[storage].launches += _build.counted(node_pass)
    return out


def fused_cgconv_eval_cuda(nodes, edges, kernel, bias, scale, bn_bias,
                           neighbors, edge_mask, mean, var, *,
                           eps: float = 1e-5, p=None):
    """Kernel 1, the apply pass (replaces pallas_cgconv.py
    ``_apply_kernel``): launch 1a writes the per-node projections P [N, 4F]
    (scratch from ``torch.empty``), launch 1b the slot pass; given ``p``
    (``fused_cgconv_node_cuda``'s P of the same nodes, kernel and bias),
    only launch 1b runs, on it. Every tensor
    must lie on one CUDA device, f32 except ``neighbors`` (int32),
    contiguous, with nodes [N, F], edges [N, M, G], neighbors [N*M] or
    [N, M], edge_mask [N*M] or [N, M], kernel [2F+G, 2F] and the four
    vectors [2F]; F <= 256, and for G > 44 W_e [G, 2F] must fit one block's
    shared memory. Neighbor indices must lie in [0, N), as pack_graphs
    makes them."""
    return _eval_pass("fused_cgconv_eval_cuda", torch.float32, nodes,
                      edges, kernel, bias, scale, bn_bias, neighbors,
                      edge_mask, mean, var, eps, p)


def fused_cgconv_eval_bf16_cuda(nodes, edges, kernel, bias, scale, bn_bias,
                                neighbors, edge_mask, mean, var, *,
                                eps: float = 1e-5, p=None):
    """The bf16 instance of kernel 1 (``fused_cgconv_eval_cuda`` with
    nodes and edges in bf16, everything else as there; its node pass
    counts in ``fused_cgconv_node_bf16_cuda.launches``). Its plain
    version is ``fused_cgconv_eval_reference`` on the widened inputs."""
    return _eval_pass("fused_cgconv_eval_bf16_cuda", torch.bfloat16, nodes,
                      edges, kernel, bias, scale, bn_bias, neighbors,
                      edge_mask, mean, var, eps, p)


fused_cgconv_eval_cuda.launches = 0
fused_cgconv_eval_bf16_cuda.launches = 0
EVAL_CUDA = {torch.float32: fused_cgconv_eval_cuda,
             torch.bfloat16: fused_cgconv_eval_bf16_cuda}


def _stats_pass(name: str, storage, nodes, edges, kernel, bias, neighbors,
                edge_mask, shift, p):
    args = dict(nodes=nodes, edges=edges, kernel=kernel, bias=bias,
                neighbors=neighbors, edge_mask=edge_mask, shift=shift)
    n, m, f, g = _check_conv_args(name, args, storage)
    smem = _stats_smem_bytes(g)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"G={g}: W_e's columns and the staged edge rows do not fit one "
            f"block's shared memory ({smem} > {_SMEM_LIMIT} bytes)")
    dev = nodes.device
    if n == 0:
        return torch.zeros((2, 2 * f), dtype=torch.float32, device=dev)
    node_pass = p is None
    if node_pass:
        p = torch.empty((n, 4 * f), dtype=torch.float32, device=dev)
    else:
        _check_p(p, n, f, nodes)
    blocks = min(-(-n * m // STATS_TILE_SLOTS), STATS_BLOCKS)
    part = torch.empty((blocks, 2, 2 * f), dtype=torch.float32, device=dev)
    out = torch.empty((2, 2 * f), dtype=torch.float32, device=dev)
    _build.launch(
        name,
        _build.entry("fused_cgconv",
                     f"cgconv_fused_stats_{INSTANCES[storage]}", 10, 6),
        (nodes.data_ptr(), edges.data_ptr(), neighbors.data_ptr(),
         edge_mask.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
         shift.data_ptr(), p.data_ptr(), part.data_ptr(), out.data_ptr()),
        dict(N=n, M=m, F=f, G=g, blocks=blocks, node_pass=int(node_pass)),
        dev)
    STATS_CUDA[storage].launches += _build.counted(1)
    NODE_CUDA[storage].launches += _build.counted(node_pass)
    return out


def fused_cgconv_stats_cuda(nodes, edges, kernel, bias, neighbors,
                            edge_mask, shift, *, p=None):
    """Kernel 2, the stats pass (replaces pallas_cgconv.py
    ``_stats_kernel``) -> [2, 2F] f32: over the real slots, the sums of
    (z - shift) and (z - shift)^2, added in a fixed order (bit-identical
    from run to run). Launch 2a is kernel 1's node pass (P [N, 4F],
    scratch), launch 2b the stats slot pass on it, 2c the partials' sum;
    given ``p`` (``fused_cgconv_node_cuda``'s P of the same nodes, kernel
    and bias), 2a is skipped and the result has the same bits. Inputs as
    ``fused_cgconv_eval_cuda``'s, with shift [2F] in place of the BN
    vectors; W_e's 128-column tiles and two staged tiles of edge rows must
    fit one block's shared memory (G up to about 200)."""
    return _stats_pass("fused_cgconv_stats_cuda", torch.float32, nodes,
                       edges, kernel, bias, neighbors, edge_mask, shift, p)


def fused_cgconv_stats_bf16_cuda(nodes, edges, kernel, bias, neighbors,
                                 edge_mask, shift, *, p=None):
    """The bf16 instance of kernel 2 (``fused_cgconv_stats_cuda`` with
    nodes and edges in bf16, staged widened to f32: the same shared
    memory). Its plain version is ``fused_cgconv_stats_reference`` on the
    widened inputs."""
    return _stats_pass("fused_cgconv_stats_bf16_cuda", torch.bfloat16,
                       nodes, edges, kernel, bias, neighbors, edge_mask,
                       shift, p)


fused_cgconv_stats_cuda.launches = 0
fused_cgconv_stats_bf16_cuda.launches = 0
STATS_CUDA = {torch.float32: fused_cgconv_stats_cuda,
              torch.bfloat16: fused_cgconv_stats_bf16_cuda}


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def _f32(t):
    return t.float().contiguous()


def instance(table: dict, nodes):
    """The kernel wrapper of ``table`` for nodes' storage type; raises
    for a type without an instance (never a cast to one that has)."""
    fn = table.get(nodes.dtype)
    if fn is None:
        raise ValueError(
            f"no instance of {table[torch.float32].__name__} for "
            f"{nodes.dtype} (instances: {sorted(map(str, table))})")
    return fn


def _kernel_dtype(impl: str, dtype):
    """The plain versions' compute type: the kernel's (f32 on the widened
    inputs) for ``'pallas'``, the structured twin's ``dtype`` for
    ``'xla'``."""
    return torch.float32 if impl == "pallas" else dtype


def fused_cgconv_eval(nodes, edges, kernel, bias, scale, bn_bias,
                      neighbors, edge_mask, mean, var, *,
                      eps: float = 1e-5, impl: str = "pallas",
                      window: int = 0, dtype=torch.float32):
    """Eval/serving mode: normalize with running stats — ONE apply pass.
    ``window`` is ignored (module docstring)."""
    del window
    if runs_kernel(impl, nodes):
        return instance(EVAL_CUDA, nodes)(
            nodes.contiguous(), edges.contiguous(), _f32(kernel),
            _f32(bias), _f32(scale), _f32(bn_bias), neighbors.contiguous(),
            _f32(edge_mask), _f32(mean), _f32(var), eps=eps)
    return fused_cgconv_eval_reference(
        nodes, edges, kernel, bias, scale, bn_bias, neighbors, edge_mask,
        mean, var, eps=eps, dtype=_kernel_dtype(impl, dtype))


class _FusedCGConv(torch.autograd.Function):
    """``impl='pallas'`` training op (module docstring)."""

    @staticmethod
    def forward(ctx, nodes, edges, kernel, bias, scale, bn_bias, neighbors,
                edge_mask, transpose, eps, dtype):
        on_card = runs_kernel("pallas", nodes)
        shift = _shift_row0(nodes, edges, kernel, bias, neighbors, dtype)
        if on_card:
            # nodes and edges in their own storage type: the instance for
            # it widens them on load (no f32 copy); the constants are f32
            conv = (nodes.contiguous(), edges.contiguous(), _f32(kernel),
                    _f32(bias))
            nbr, emask = neighbors.contiguous(), _f32(edge_mask)
            # one node pass feeds both slot passes
            p = instance(NODE_CUDA, nodes)(conv[0], conv[2], conv[3])
            s = instance(STATS_CUDA, nodes)(*conv, nbr, emask, shift, p=p)
        else:
            s = fused_cgconv_stats_reference(
                nodes, edges, kernel, bias, neighbors, edge_mask, shift)
        n_real = edge_mask.float().sum()
        c = torch.clamp_min(n_real, 1.0)
        mean_s = s[0] / c
        var = torch.clamp_min(s[1] / c - mean_s * mean_s, 0.0)
        mean = mean_s + shift
        if on_card:
            agg = instance(EVAL_CUDA, nodes)(
                *conv, _f32(scale), _f32(bn_bias), nbr, emask, mean, var,
                eps=eps, p=p)
        else:
            agg = fused_cgconv_eval_reference(
                nodes, edges, kernel, bias, scale, bn_bias, neighbors,
                edge_mask, mean, var, eps=eps)
        ctx.save_for_backward(nodes, edges, kernel, bias, scale, bn_bias,
                              neighbors, edge_mask, mean,
                              torch.rsqrt(var + eps), n_real,
                              *(transpose or ()))
        ctx.dtype = dtype
        ctx.mark_non_differentiable(mean, var, n_real)
        return agg, mean, var, n_real

    @staticmethod
    def backward(ctx, ct_agg, *_stats_cts):
        (nodes, edges, kernel, bias, scale, bn_bias, neighbors, edge_mask,
         mean, rstd, n_real, *transpose) = ctx.saved_tensors
        n, m, g = edges.shape
        f = nodes.shape[-1]
        k = kernel.to(ctx.dtype)
        # rematerialize z (plain matmuls) from the saved inputs
        v_j = gather(nodes, neighbors.reshape(-1)).to(ctx.dtype)
        e = edges.to(ctx.dtype)
        z = ((nodes.to(ctx.dtype) @ k[:f])[:, None, :]
             + (v_j @ k[f: 2 * f]).reshape(n, m, 2 * f)
             + e @ k[2 * f:] + bias.to(ctx.dtype))
        cst = pack_cst(mean, rstd, scale, bn_bias)
        dz, d_scale, d_bias = epilogue_backward(
            z, edge_mask, cst, n_real, ct_agg, "pallas")
        dz = dz.to(ctx.dtype)
        dz_node = dz.sum(dim=1)
        dz2 = dz.reshape(n * m, 2 * f)
        d_kernel = torch.cat([nodes.to(ctx.dtype).T @ dz_node, v_j.T @ dz2,
                              e.reshape(n * m, g).T @ dz2])
        d_vj = dz2 @ k[f: 2 * f].T
        if transpose:
            d_nodes = transpose_cotangent(d_vj, *transpose, n)
        else:
            d_nodes = torch.zeros_like(d_vj[:n]).index_add_(
                0, neighbors.reshape(-1), d_vj)
        d_nodes = d_nodes + dz_node @ k[:f].T
        d_edges = (dz @ k[2 * f:].T).to(edges.dtype) \
            if ctx.needs_input_grad[1] else None
        return (d_nodes.to(nodes.dtype), d_edges, d_kernel.to(kernel.dtype),
                dz2.sum(dim=0).to(bias.dtype), d_scale.to(scale.dtype),
                d_bias.to(bn_bias.dtype), None, None, None, None, None)


def fused_cgconv(nodes, edges, kernel, bias, scale, bn_bias, neighbors,
                 edge_mask, transpose_args=None, *, eps: float = 1e-5,
                 impl: str = "pallas", window: int = 0,
                 dtype=torch.float32):
    """(agg [N, F] f32, mean [2F], var [2F], n_real) — training mode.

    Differentiable in (nodes, edges, kernel, bias, scale, bn_bias); the
    stats outputs feed the running-stat update and carry no gradient.
    ``transpose_args`` = ``(in_slots, in_mask, over_slots, over_nodes,
    over_mask)`` routes the v_j cotangent through the scatter-free
    transpose (or ``None``: the plain scatter). ``window`` is ignored.
    """
    del window
    check_impl(impl)
    tr = None
    if transpose_args is not None and transpose_args[0] is not None:
        tr = tuple(transpose_args)
    if impl == "xla":
        return _forward_structured(nodes, edges, kernel, bias, scale,
                                   bn_bias, neighbors, edge_mask, tr, eps,
                                   dtype)
    return _FusedCGConv.apply(nodes, edges, kernel, bias, scale, bn_bias,
                              neighbors, edge_mask, tr, eps, dtype)


# ---------------------------------------------------------------------------
# cost model (the bound chip_smoke.py reports)
# ---------------------------------------------------------------------------


def fused_conv_hbm_bytes(n: int, m: int, g: int, f: int,
                         dtype_bytes: int = 4) -> dict:
    """The TPU kernel's analytic HBM byte model, copied from the JAX
    package: per training-mode forward, TWO passes read the block inputs
    (nodes counted twice there: block rows + window tiles), ONE [N, F]
    f32 write, zero intermediate tensors."""
    edges_b = n * m * g * dtype_bytes
    nodes_b = 2 * n * f * dtype_bytes  # block rows + window tiles
    nbr_b = n * m * 4
    mask_b = n * m * 4
    params_b = (2 * f + g) * 2 * f * 4
    read_once = edges_b + nodes_b + nbr_b + mask_b + params_b
    write_b = n * f * 4
    return {
        "reads_per_pass": read_once,
        "passes": 2,
        "write_bytes": write_b,
        "model_bytes": 2 * read_once + write_b,
    }


def touched_nodes(neighbors, edge_mask, n: int) -> int:
    """Nodes that a real slot touches, as its center or as its neighbor:
    the rows whose projections kernel 1's node pass needs. ``neighbors``
    and ``edge_mask`` hold N*M entries ([N*M] or [N, M])."""
    real = edge_mask.reshape(n, -1) > 0
    hit = torch.zeros(n, dtype=torch.bool, device=real.device)
    hit[real.any(dim=1)] = True
    hit[neighbors.reshape(n, -1)[real].long()] = True
    return int(hit.sum())


def unfactored_flops(f: int, g: int, real_slots: int, real_rows: int) -> int:
    """f32 operations of z taken whole per slot (the first designs of
    kernels 1 and 2): v_i . W[0:F] once for each row with a real slot,
    v_j . W[F:2F] and e . W[2F:] for each real slot."""
    return 2 * 2 * f * (real_rows * f + real_slots * (f + g))


def _pass_bytes(n: int, m: int, g: int, f: int,
                storage_bytes: int = 4) -> int:
    """The compulsory bytes of one apply pass: ``fused_conv_hbm_bytes``'s
    inputs read once (nodes once: the GPU has no window tiles; nodes and
    edges at ``storage_bytes`` an element, 2 for the bf16 instances), the
    four [2F] vectors, the [N, F] f32 output written once."""
    b = fused_conv_hbm_bytes(n, m, g, f, dtype_bytes=storage_bytes)
    return (b["reads_per_pass"] - n * f * storage_bytes + 4 * 2 * f * 4
            + b["write_bytes"])


def _factored_flops(g: int, f: int, real_slots: int, touched: int) -> int:
    """The least work of z on this data: 2 F 4F for each of the
    ``touched`` nodes (center or neighbor of a real slot: its [v_i W_i |
    v_j W_j] projections) plus 2 G 2F for each real slot (e . W_e)."""
    return 2 * f * 4 * f * touched + 2 * g * 2 * f * real_slots


def eval_pass_cost(n: int, m: int, g: int, f: int, real_slots: int,
                   touched: int, storage_bytes: int = 4) -> dict:
    """Compulsory work of one eval pass on this data, counted as the least
    work (the factored z, ``_factored_flops``); bytes as ``_pass_bytes``
    (the P scratch is not compulsory). The gate's transcendentals are not
    counted."""
    return {"bytes": _pass_bytes(n, m, g, f, storage_bytes),
            "flops": _factored_flops(g, f, real_slots, touched)}


def stats_pass_cost(n: int, m: int, g: int, f: int, real_slots: int,
                    touched: int, storage_bytes: int = 4) -> dict:
    """Compulsory work of one stats pass on this data: the inputs of
    ``eval_pass_cost`` with the shift [2F] in place of the three BN
    vectors and the [2, 2F] sums in place of the [N, F] output; FLOPs the
    least work of z (``_factored_flops``) plus three operations (subtract,
    add, multiply-add) per real slot and channel for the two moments. The
    count of z taken whole per slot, the first design's work, is
    ``unfactored_flops`` plus the same three."""
    nbytes = (_pass_bytes(n, m, g, f, storage_bytes) - 2 * 2 * f * 4
              - n * f * 4 + 2 * 2 * f * 4)
    return {"bytes": nbytes,
            "flops": _factored_flops(g, f, real_slots, touched)
            + 3 * real_slots * 2 * f}


# ---------------------------------------------------------------------------
# parameter shells (the JAX FcFullParams / BN1Params layout)
# ---------------------------------------------------------------------------


class FcFullParams(nn.Module):
    """``fc_full``'s parameters without its compute: ``kernel`` stays in
    the JAX layout [2F+G, 2F] (the layout the kernel reads) and ``bias``
    is [2F]. The unfused path computes with the same two tensors. (The
    JAX ``BN1Params`` shell has no separate counterpart: ``bn1`` is an
    ops/norm.py MaskedBatchNorm, whose weight/bias/running_mean/running_var
    are BN1Params's scale/bias and batch_stats mean/var.)"""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))
