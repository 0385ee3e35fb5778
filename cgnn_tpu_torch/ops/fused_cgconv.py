"""Whole-conv fused CGConv, eval pass (``cgnn_tpu/ops/pallas_cgconv.py``).

gather -> fc_full -> BN1 (running stats) -> sigmoid*softplus gate ->
masked sum over the M edge slots, as one op that writes only the [N, F]
aggregate. Three pieces:

- ``fused_cgconv_eval_cuda``: the wrapper of the hand-written Hopper
  kernel (``csrc/fused_cgconv.cu``, which replaces the TPU
  ``_apply_kernel``). It takes CUDA tensors only, checks them, launches on
  the current stream, raises on a refused launch, and counts its launches
  in ``fused_cgconv_eval_cuda.launches``;
- ``fused_cgconv_eval_reference``: the kernel's plain PyTorch version, a
  port of ``_apply_structured`` + ``_z_structured`` + ``_gate_sum``;
- ``fused_cgconv_eval``: the public op with the JAX signature (minus
  ``transpose_args``; ``window`` is accepted and ignored, since the GPU
  gathers rows directly). ``impl='pallas'`` runs the plain version for a
  tensor that lies on the CPU and the kernel for any other, which launches
  or raises; ``impl='xla'`` is the plain version on any device.

Numerical contract: the dense CGConv branch in models/cgcnn.py, to f32
roundoff. Padding slots are selected to 0, never multiplied.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from cgnn_tpu_torch.ops.segment import gather


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, max(x, 0) + log1p(exp(-|x|)) (torch's
    own softplus switches to the identity above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _z_structured(nodes, edges, kernel, bias, neighbors, dtype):
    """fc_full(v_i, v_j, e) without materializing the concat."""
    n, m = edges.shape[0], edges.shape[1]
    f = nodes.shape[-1]
    k = kernel.to(dtype)
    v_j = gather(nodes, neighbors.reshape(-1)).reshape(n, m, f)
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
    """Plain PyTorch version of the eval pass (the JAX ``impl='xla'``)."""
    n, m = edges.shape[0], edges.shape[1]
    rstd = torch.rsqrt(var.float() + eps)
    z = _z_structured(nodes, edges, kernel, bias, neighbors, dtype)
    y = (z.float() - mean.float()) * (rstd * scale) + bn_bias
    return _gate_sum(y, edge_mask.reshape(n, m).float())


# ---------------------------------------------------------------------------
# the Hopper kernel
# ---------------------------------------------------------------------------

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _kernel_lib():
    from cgnn_tpu_torch.ops import _build

    lib = _build.load("fused_cgconv")
    fn = lib.cgconv_fused_eval_f32
    if fn.argtypes is None:
        fn.argtypes = [_VOID] * 10 + [_INT] * 5 + [_VOID]
        fn.restype = _INT
    return fn


_SMEM_LIMIT = 232448  # bytes of shared memory one block may opt into


def _rows_per_block(f: int) -> int:
    return max(1, min(8, 1024 // f))


def _smem_bytes(f: int, g: int, rows: int) -> int:
    """The kernel's dynamic shared memory: W plus per-row v_i/v_j/e rows
    (cgconv_fused_eval_smem_bytes in the CUDA source)."""
    return 4 * ((2 * f + g) * 2 * f + rows * (2 * f + g))


def fused_cgconv_eval_cuda(nodes, edges, kernel, bias, scale, bn_bias,
                           neighbors, edge_mask, mean, var, *,
                           eps: float = 1e-5):
    """Launch the Hopper kernel (module docstring). Every tensor must lie
    on one CUDA device, f32 except ``neighbors`` (int32), contiguous, with
    nodes [N, F], edges [N, M, G], neighbors [N*M] or [N, M], edge_mask
    [N*M] or [N, M], kernel [2F+G, 2F] and the four vectors [2F].
    Neighbor indices must lie in [0, N), as pack_graphs makes them."""
    args = dict(nodes=nodes, edges=edges, kernel=kernel, bias=bias,
                scale=scale, bn_bias=bn_bias, neighbors=neighbors,
                edge_mask=edge_mask, mean=mean, var=var)
    dev = nodes.device
    if dev.type != "cuda":
        raise ValueError(
            f"fused_cgconv_eval_cuda takes CUDA tensors, got {dev}")
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, nodes on {dev}")
        want = torch.int32 if name == "neighbors" else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nodes.dim() != 2 or edges.dim() != 3:
        raise ValueError(
            f"nodes must be [N, F] and edges [N, M, G], got "
            f"{tuple(nodes.shape)} and {tuple(edges.shape)}")
    n, f = nodes.shape
    m, g = edges.shape[1], edges.shape[2]
    shapes = {
        "edges": (edges.shape[0] == n, f"[{n}, M, G]"),
        "neighbors": (neighbors.numel() == n * m, f"{n * m} entries"),
        "edge_mask": (edge_mask.numel() == n * m, f"{n * m} entries"),
        "kernel": (tuple(kernel.shape) == (2 * f + g, 2 * f),
                   f"[{2 * f + g}, {2 * f}]"),
    }
    for name in ("bias", "scale", "bn_bias", "mean", "var"):
        shapes[name] = (tuple(args[name].shape) == (2 * f,), f"[{2 * f}]")
    for name, (ok, want) in shapes.items():
        if not ok:
            raise ValueError(
                f"{name} must be {want}, got {tuple(args[name].shape)}")
    if f > 1024:
        raise ValueError(f"F={f} exceeds the kernel's 1024 threads per row")
    rows = _rows_per_block(f)
    if _smem_bytes(f, g, rows) > _SMEM_LIMIT:
        raise ValueError(
            f"F={f}, G={g}: W [{2 * f + g}, {2 * f}] does not fit one "
            f"block's shared memory ({_smem_bytes(f, g, rows)} > "
            f"{_SMEM_LIMIT} bytes)")
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = _kernel_lib()
    # the BN fold the JAX wrapper does before its apply pass
    rstd_scale = (torch.rsqrt(var + eps) * scale).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nodes.data_ptr(), edges.data_ptr(), neighbors.data_ptr(),
                 edge_mask.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                 mean.data_ptr(), rstd_scale.data_ptr(), bn_bias.data_ptr(),
                 out.data_ptr(), n, m, f, g, rows, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_cgconv_eval kernel launch failed: cudaError {err} "
            f"(N={n}, M={m}, F={f}, G={g})")
    fused_cgconv_eval_cuda.launches += 1
    return out


fused_cgconv_eval_cuda.launches = 0


def fused_cgconv_eval(nodes, edges, kernel, bias, scale, bn_bias,
                      neighbors, edge_mask, mean, var, *,
                      eps: float = 1e-5, impl: str = "pallas",
                      window: int = 0, dtype=torch.float32):
    """Eval/serving mode: normalize with running stats — ONE apply pass.
    ``window`` is ignored (module docstring)."""
    del window
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    if impl == "pallas" and nodes.device.type != "cpu":
        return fused_cgconv_eval_cuda(
            nodes, edges, kernel, bias, scale, bn_bias, neighbors,
            edge_mask, mean, var, eps=eps)
    return fused_cgconv_eval_reference(
        nodes, edges, kernel, bias, scale, bn_bias, neighbors, edge_mask,
        mean, var, eps=eps, dtype=dtype)


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


def eval_pass_cost(n: int, m: int, g: int, f: int, real_slots: int,
                   real_rows: int) -> dict:
    """Compulsory work of one eval pass on this data: the apply pass of
    ``fused_conv_hbm_bytes`` with every input read once (nodes once — the
    GPU has no window tiles — plus the four [2F] vectors) and the output
    written once; FLOPs are the f32 FMAs the data needs: the v_i term for
    each row with a real slot, the v_j and edge terms for each real slot.
    The gate's transcendentals are not counted."""
    b = fused_conv_hbm_bytes(n, m, g, f)
    nbytes = (b["reads_per_pass"] - n * f * 4 + 4 * 2 * f * 4
              + b["write_bytes"])
    flops = 2 * 2 * f * (real_rows * f + real_slots * (f + g))
    return {"bytes": nbytes, "flops": flops}


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

