"""Fused conv epilogue on a materialized z [N, M, 2F]
(``cgnn_tpu/ops/fused_epilogue.py``): masked BN1 normalize -> gate ->
edge mask -> sum over M, with the hand backward of that chain.

    forward:  stats (plain torch)  +  apply (kernel 3, writes [N, F])
    backward: reduce (kernel 4, [4, 2F])  +  dz (kernel 5, writes [N, M, 2F])

Each pass has three pieces here:

- the wrapper of its hand-written Hopper kernel (``csrc/fused_epilogue.cu``:
  ``epilogue_apply_cuda``, ``epilogue_reduce_cuda``, ``epilogue_dz_cuda``),
  which takes CUDA tensors only, launches on the current stream, raises on
  a refused launch and counts its launches in ``<wrapper>.launches``;
- its plain PyTorch version (``*_reference``, the JAX ``_apply_xla`` and
  ``_bwd_xla`` split the way the kernels split them);
- a dispatcher that takes the kernel for ``impl='pallas'`` on a tensor
  that is not on the CPU (launch or raise, never a fallback) and the plain
  version otherwise.

bf16 z: kernels 3, 4 and 5 have bf16 instances (``epilogue_apply_bf16_cuda``,
``epilogue_reduce_bf16_cuda``, ``epilogue_dz_bf16_cuda``) that widen z on
load and compute in f32; kernel 3 writes its f32 sum, kernel 5 dz in
bf16, as ``_apply_kernel``, ``_reduce_kernel`` and ``_dz_kernel`` do.
Their plain versions are the f32 ones on the widened z, dz cast to z's
type. A z of another dtype on the card under ``'pallas'`` raises.

The batch statistics stay in plain torch (``masked_stats``, the JAX
estimator). Kernels 4 and 5 also serve the backward of the whole-conv op
(ops/fused_cgconv.py). ``FusedBN1GateSum`` is the module: its parameter and
buffer names are ``bn1``'s (a MaskedBatchNorm), so convert.py maps it
unchanged. Padding slots are selected to 0, never multiplied.
"""

from __future__ import annotations

import torch

from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.ops.norm import MaskedBatchNorm, update_running_stats


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, max(x, 0) + log1p(exp(-|x|)) (torch's
    own softplus switches to the identity above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def masked_stats(z: torch.Tensor, mask: torch.Tensor):
    """Shifted one-pass masked moments over the (N, M) axes, in f32:
    -> (mean [2F], biased var [2F], n_real []). The shift is the mean of
    row 0 (the ops/norm.py estimator); it carries no gradient."""
    zf = z.float()
    shift = zf[:1].mean(dim=(0, 1)).detach()
    zs = zf - shift
    m = mask.float()
    n_real = m.sum()
    zm = zs * m[..., None]
    s1 = zm.sum(dim=(0, 1))
    s2 = (zm * zs).sum(dim=(0, 1))
    n = torch.clamp_min(n_real, 1.0)
    mean_s = s1 / n
    var = torch.clamp_min(s2 / n - mean_s * mean_s, 0.0)
    return mean_s + shift, var, n_real


def pack_cst(mean, rstd, scale, bias) -> torch.Tensor:
    """[4, 2F] f32 rows mean, rstd, scale, bias: what every pass reads."""
    return torch.stack([mean.float(), rstd.float(), scale.float(),
                        bias.float()]).contiguous()


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _keep(mask):
    return (mask > 0)[..., None]


def gate_grad(y, mask, ct):
    """dL/dy [N, M, 2F] from ct [N, F] through sigmoid(gate) *
    softplus(core), masked slots selected to 0."""
    f = y.shape[-1] // 2
    sg = torch.sigmoid(y[..., :f])
    spg = torch.sigmoid(y[..., f:])  # softplus' = sigmoid
    sp = softplus(y[..., f:])
    dmsg = ct[:, None, :]
    g = torch.cat([dmsg * sg * (1.0 - sg) * sp, dmsg * sg * spg], dim=-1)
    return torch.where(_keep(mask), g, g.new_zeros(()))


def epilogue_apply_reference(z, mask, cst):
    """Kernel 3's plain version: y = (z - mean) * (rstd * scale) + bias,
    masked sum over M of sigmoid(y[:F]) * softplus(y[F:]) -> [N, F] f32."""
    mean, rstd, scale, bias = cst
    y = (z.float() - mean) * (rstd * scale) + bias
    f = y.shape[-1] // 2
    msg = torch.sigmoid(y[..., :f]) * softplus(y[..., f:])
    return torch.where(_keep(mask), msg, msg.new_zeros(())).sum(dim=1)


def _xhat_grad(z, mask, cst, ct):
    mean, rstd, scale, bias = cst
    xhat = (z.float() - mean) * rstd
    xhat = torch.where(_keep(mask), xhat, xhat.new_zeros(()))
    g = gate_grad(xhat * scale + bias, mask, ct.float())
    return xhat, g, g * scale


def epilogue_reduce_reference(z, mask, cst, ct):
    """Kernel 4's plain version -> [4, 2F]: per channel, over the masked
    slots, sum g (d_bias), sum g * xhat (d_scale), sum dxhat and
    sum dxhat * xhat, with g = dL/dy and dxhat = g * scale."""
    xhat, g, dxhat = _xhat_grad(z, mask, cst, ct)
    return torch.stack([
        g.sum(dim=(0, 1)),
        (g * xhat).sum(dim=(0, 1)),
        dxhat.sum(dim=(0, 1)),
        (dxhat * xhat).sum(dim=(0, 1)),
    ])


def epilogue_dz_reference(z, mask, cst, red5, ct):
    """Kernel 5's plain version: dz = rstd * (dxhat - mask * (mean dxhat +
    xhat * mean(dxhat * xhat))), the means over the real slots
    (``red5`` rows 2 and 3 times row 4, which holds 1 / max(n_real, 1))."""
    xhat, _, dxhat = _xhat_grad(z, mask, cst, ct)
    rstd = cst[1]
    mean_dxhat = red5[2] * red5[4, 0]
    mean_dxhat_xhat = red5[3] * red5[4, 0]
    dz = rstd * (dxhat - (mean_dxhat + xhat * mean_dxhat_xhat))
    return torch.where(_keep(mask), dz, dz.new_zeros(())).to(z.dtype)


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------

VECTOR_WIDTH = {torch.float32: 4, torch.bfloat16: 8}  # 16 bytes of z


def vector_width(f: int, z_dtype, ptrs) -> int:
    """Kernels 3 and 5's V, the last int of their C entries: the z values
    a thread moves as one 16-byte vector (4 f32, 8 bf16) where F is a
    multiple of it and every address in ``ptrs`` (the tensors the kernel
    reads or writes in vectors) is 16-byte aligned; else 1, the scalar
    path of the same kernel."""
    v = VECTOR_WIDTH[z_dtype]
    return v if f % v == 0 and all(p % 16 == 0 for p in ptrs) else 1


REDUCE_BLOCKS = 264  # kernel 4's persistent grid: at most two blocks an
                     # SM of an H100's 132, one [4, 2F] partial each


def _check(name, z, mask, cst, extra: dict,
           z_dtype=torch.float32) -> tuple[int, int, int]:
    """Device, dtype, contiguity and shape checks shared by the
    wrappers: z of the instance's type ``z_dtype``, the rest f32;
    -> (N, M, F)."""
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if z.dim() != 3 or z.shape[-1] % 2:
        raise ValueError(f"z must be [N, M, 2F], got {tuple(z.shape)}")
    n, m, two_f = z.shape
    f = two_f // 2
    if f > 1024:
        raise ValueError(f"F={f} exceeds the kernels' 1024 threads per row")
    want = {"z": (n, m, two_f), "mask": (n, m), "cst": (4, two_f)}
    args = {"z": z, "mask": mask, "cst": cst}
    for k, (t, shape) in extra.items():
        args[k], want[k] = t, shape
    for k, t in args.items():
        if t.device != dev:
            raise ValueError(f"{k} is on {t.device}, z on {dev}")
        dtype = z_dtype if k == "z" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{k} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k} must be {list(want[k])}, got "
                             f"{list(t.shape)}")
    return n, m, f


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _launch(name: str, n_ptrs: int, ptrs, n, m, f, dev, last: dict,
            z_dtype=torch.float32):
    """Launch ``<name>_f32`` (``_bf16`` for a bf16 z) with N, M, F and one
    more int, ``last``: kernel 4's ``blocks``, kernels 3 and 5's ``v``."""
    _build.launch(name, _build.entry(
        "fused_epilogue", f"{name}_{_SUFFIX[z_dtype]}", n_ptrs, 4), ptrs,
        dict(N=n, M=m, F=f, **last), dev)


def _apply(name, z_dtype, z, mask, cst):
    n, m, f = _check(name, z, mask, cst, {}, z_dtype)
    out = torch.empty((n, f), dtype=torch.float32, device=z.device)
    if n == 0:
        return out
    ptrs = (z.data_ptr(), mask.data_ptr(), cst.data_ptr(), out.data_ptr())
    v = vector_width(f, z_dtype, ptrs[:1] + ptrs[2:])
    _launch("epilogue_apply", 4, ptrs, n, m, f, z.device, {"v": v}, z_dtype)
    APPLY_CUDA[z_dtype].launches += _build.counted(1)
    return out


def epilogue_apply_cuda(z, mask, cst):
    """Kernel 3 (replaces fused_epilogue.py ``_apply_kernel``): z [N, M,
    2F], mask [N, M], cst [4, 2F], all f32 on one CUDA device -> [N, F]."""
    return _apply("epilogue_apply_cuda", torch.float32, z, mask, cst)


def epilogue_apply_bf16_cuda(z, mask, cst):
    """The bf16 instance of kernel 3: z bf16, widened on load; the rest
    and the [N, F] sum f32, as ``epilogue_apply_cuda``'s."""
    return _apply("epilogue_apply_bf16_cuda", torch.bfloat16, z, mask, cst)


def _reduce(name, z_dtype, z, mask, cst, ct):
    n, m, f = _check(name, z, mask, cst,
                     {"ct": (ct, (z.shape[0], z.shape[-1] // 2))}, z_dtype)
    if n == 0:
        return torch.zeros((4, 2 * f), dtype=torch.float32, device=z.device)
    out = torch.empty((4, 2 * f), dtype=torch.float32, device=z.device)
    blocks = min(n, REDUCE_BLOCKS)
    part = torch.empty((blocks, 4, 2 * f), dtype=torch.float32,
                       device=z.device)
    _launch("epilogue_reduce", 6,
            (z.data_ptr(), mask.data_ptr(), cst.data_ptr(), ct.data_ptr(),
             part.data_ptr(), out.data_ptr()), n, m, f, z.device,
            {"blocks": blocks}, z_dtype)
    REDUCE_CUDA[z_dtype].launches += _build.counted(1)
    return out


def epilogue_reduce_cuda(z, mask, cst, ct):
    """Kernel 4 (replaces fused_epilogue.py ``_reduce_kernel``): -> [4, 2F],
    one partial for each of at most ``REDUCE_BLOCKS`` blocks, summed in a
    fixed order (bit-identical run to run)."""
    return _reduce("epilogue_reduce_cuda", torch.float32, z, mask, cst, ct)


def epilogue_reduce_bf16_cuda(z, mask, cst, ct):
    """The bf16 instance of kernel 4: z bf16, the rest as
    ``epilogue_reduce_cuda``'s."""
    return _reduce("epilogue_reduce_bf16_cuda", torch.bfloat16, z, mask,
                   cst, ct)


def _dz(name, z_dtype, z, mask, cst, red5, ct):
    n, m, f = _check(name, z, mask, cst,
                     {"red5": (red5, (5, z.shape[-1])),
                      "ct": (ct, (z.shape[0], z.shape[-1] // 2))}, z_dtype)
    out = torch.empty_like(z)
    if n == 0:
        return out
    ptrs = (z.data_ptr(), mask.data_ptr(), cst.data_ptr(), red5.data_ptr(),
            ct.data_ptr(), out.data_ptr())
    v = vector_width(f, z_dtype, ptrs[:1] + ptrs[2:])
    _launch("epilogue_dz", 6, ptrs, n, m, f, z.device, {"v": v}, z_dtype)
    DZ_CUDA[z_dtype].launches += _build.counted(1)
    return out


def epilogue_dz_cuda(z, mask, cst, red5, ct):
    """Kernel 5 (replaces fused_epilogue.py ``_dz_kernel``): -> dz [N, M,
    2F], written once, padding slots 0."""
    return _dz("epilogue_dz_cuda", torch.float32, z, mask, cst, red5, ct)


def epilogue_dz_bf16_cuda(z, mask, cst, red5, ct):
    """The bf16 instance of kernel 5: z bf16 -> dz bf16 (each value the
    f32 instance's, rounded to nearest even), the rest f32."""
    return _dz("epilogue_dz_bf16_cuda", torch.bfloat16, z, mask, cst, red5,
               ct)


epilogue_apply_cuda.launches = 0
epilogue_apply_bf16_cuda.launches = 0
epilogue_reduce_cuda.launches = 0
epilogue_reduce_bf16_cuda.launches = 0
epilogue_dz_cuda.launches = 0
epilogue_dz_bf16_cuda.launches = 0
APPLY_CUDA = {torch.float32: epilogue_apply_cuda,
              torch.bfloat16: epilogue_apply_bf16_cuda}
REDUCE_CUDA = {torch.float32: epilogue_reduce_cuda,
               torch.bfloat16: epilogue_reduce_bf16_cuda}
DZ_CUDA = {torch.float32: epilogue_dz_cuda,
           torch.bfloat16: epilogue_dz_bf16_cuda}


# ---------------------------------------------------------------------------
# dispatch and the op
# ---------------------------------------------------------------------------


def check_impl(impl: str) -> None:
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")


def runs_kernel(impl: str, t: torch.Tensor) -> bool:
    """Whether ``impl`` on tensor ``t`` takes a kernel: ``'pallas'`` on
    any tensor not on the CPU (launch or raise, never a fallback)."""
    check_impl(impl)
    return impl == "pallas" and t.device.type != "cpu"


def epilogue_apply(z, mask, cst, impl: str):
    if runs_kernel(impl, z):
        if z.dtype not in APPLY_CUDA:
            raise ValueError(f"kernel 3 has no instance for z of {z.dtype}")
        return APPLY_CUDA[z.dtype](z.contiguous(),
                                   mask.float().contiguous(), cst)
    return epilogue_apply_reference(z, mask, cst)


def epilogue_backward(z, mask, cst, n_real, ct, impl: str):
    """The BN1 -> gate -> sum backward -> (dz, d_scale, d_bias): kernel 4,
    then kernel 5 with 1 / max(n_real, 1) precomputed."""
    on_card = runs_kernel(impl, z)
    if on_card:
        if z.dtype not in REDUCE_CUDA:
            raise ValueError(f"kernels 4 and 5 have no instance for z of "
                             f"{z.dtype}")
        z, mask = z.contiguous(), mask.float().contiguous()
        ct = ct.float().contiguous()
        red = REDUCE_CUDA[z.dtype](z, mask, cst, ct)
    else:
        red = epilogue_reduce_reference(z, mask, cst, ct)
    inv_c = (1.0 / torch.clamp_min(n_real.float(), 1.0)) * red.new_ones(
        (1, red.shape[1]))
    red5 = torch.cat([red, inv_c], dim=0)
    if on_card:
        dz = DZ_CUDA[z.dtype](z, mask, cst, red5, ct)
    else:
        dz = epilogue_dz_reference(z, mask, cst, red5, ct)
    return dz, red[1], red[0]


class _FusedEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, mask, scale, bias, eps, impl):
        mean, var, n_real = masked_stats(z, mask)
        cst = pack_cst(mean, torch.rsqrt(var + eps), scale, bias)
        agg = epilogue_apply(z, mask, cst, impl)
        ctx.save_for_backward(z, mask, cst, n_real)
        ctx.impl = impl
        ctx.mark_non_differentiable(mean, var, n_real)
        return agg, mean, var, n_real

    @staticmethod
    def backward(ctx, ct_agg, *_stats_cts):
        # the stats outputs feed only the running-stat update: no gradient
        z, mask, cst, n_real = ctx.saved_tensors
        dz, d_scale, d_bias = epilogue_backward(z, mask, cst, n_real, ct_agg,
                                                ctx.impl)
        return dz.to(z.dtype), None, d_scale, d_bias, None, None


def fused_epilogue(z, mask, scale, bias, eps: float = 1e-5,
                   impl: str = "xla"):
    """(agg [N, F] f32, mean [2F], var [2F], n_real) — training mode.
    Differentiable in (z, scale, bias); the stats outputs are not."""
    check_impl(impl)
    return _FusedEpilogue.apply(z, mask, scale, bias, eps, impl)


def fused_epilogue_eval(z, mask, scale, bias, mean, var, eps: float = 1e-5,
                        impl: str = "xla"):
    """Eval mode: normalize with the running statistics, gate, mask, sum."""
    cst = pack_cst(mean, torch.rsqrt(var.float() + eps), scale, bias)
    return epilogue_apply(z, mask, cst, impl)


class FusedBN1GateSum(MaskedBatchNorm):
    """CGConv's BN1 -> gate -> mask -> sum chain as one op. A
    MaskedBatchNorm's parameters and buffers (so ``bn1`` keeps its names);
    ``forward(z [N, M, 2F], mask [N, M])`` returns the [N, F] f32 message
    sum and, in train mode, updates the running statistics in place."""

    def __init__(self, features: int, impl: str = "xla", eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(features, eps=eps, momentum=momentum)
        check_impl(impl)
        self.impl = impl

    def forward(self, z, mask):
        if not self.training:
            return fused_epilogue_eval(z, mask, self.weight, self.bias,
                                       self.running_mean, self.running_var,
                                       self.eps, self.impl)
        agg, mean, var, n_real = fused_epilogue(z, mask, self.weight,
                                                self.bias, self.eps,
                                                self.impl)
        update_running_stats(self.running_mean, self.running_var, mean, var,
                             n_real, self.momentum)
        return agg


# ---------------------------------------------------------------------------
# cost model (the bounds chip_smoke.py reports)
# ---------------------------------------------------------------------------


def epilogue_pass_cost(kind: str, n: int, m: int, f: int,
                       real_slots: int, z_bytes: int = 4) -> dict:
    """Compulsory bytes and f32 operations of one pass on this data: every
    input read once, every output written once (z [N, M, 2F], mask [N, M],
    cst [4, 2F], ct [N, F], red5 [5, 2F]; outputs agg [N, F], red [4, 2F],
    dz [N, M, 2F]; ``z_bytes`` a z and dz element: 2 for the bf16
    instances). Operations: the arithmetic per real slot and channel
    (apply 5, reduce 16, dz 19, counting each transcendental as one)."""
    z_b = n * m * 2 * f * z_bytes
    base = z_b + n * m * 4 + 4 * 2 * f * 4
    nbytes = {
        "apply": base + n * f * 4,
        "reduce": base + n * f * 4 + 4 * 2 * f * 4,
        "dz": base + 5 * 2 * f * 4 + n * f * 4 + z_b,
    }[kind]
    per = {"apply": 5, "reduce": 16, "dz": 19}[kind]
    return {"bytes": nbytes, "flops": per * real_slots * 2 * f}
