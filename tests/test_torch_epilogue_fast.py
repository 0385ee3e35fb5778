"""The arithmetic of kernels 3 and 5 (ops/csrc/fused_epilogue.cu) as they
compute it on the card, held to the JAX package on the CPU.

The kernels take the gate with one exp a half: t = exp(-|y|), sigmoid(y)
= 1/(1+t) for y >= 0, else t/(1+t), softplus(y) = max(y, 0) + log(1 +
t) (the log of the rounded 1 + t, as the kernels' fast log takes it),
and softplus' = sigmoid. ``gate_fast`` and ``gate_grad_fast`` below are
that form in plain PyTorch, in the kernels' order of operations (no card
is needed to check its algebra); ``apply_pass`` and ``dz_pass`` are
kernels 3 and 5 built on them (kernel 3 adds the slots in order s = 0 ..
M-1; padding slots are selected to 0, never multiplied). They are held to
the JAX ``_gate``, ``_gate_grad``, ``_apply_xla`` and ``_bwd_xla``
(cgnn_tpu/ops/fused_epilogue.py) on seeded numpy inputs and on the edges
of the gate's domain, with the kernel phase's tolerance (rtol 1e-4, atol
1e-5, chip_smoke.py ``RTOL``/``ATOL``) in f32 and 1e-12 in f64. The
kernels' one-instruction exp, reciprocal and log run only on the card
(tests/test_torch_cuda.py, chip_smoke.py). Last, the wrapper's choice of
the kernels' vector width (``vector_width``) for F = 1 .. 130.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.ops import fused_epilogue as jfe
from cgnn_tpu_torch.ops import fused_epilogue as tfe

TOL = {np.float32: dict(rtol=1e-4, atol=1e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
# the gate's domain edges: 0, tiny, where exp(-|y|) under- and overflows
# f32 (|y| 88, 100), subnormals
EDGES = np.array([0.0, -0.0, 1e-8, -1e-8, 20.0, -20.0, 88.0, -88.0, 100.0,
                  -100.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45, 3.0, -3.0])


def _sigmoid(y, t, r):
    return torch.where(y >= 0, r, t * r)


def gate_fast(y_g, y_c):
    """sigmoid(y_g) * softplus(y_c) as kernel 3's ``gate_fast``."""
    t_g = torch.exp(-torch.abs(y_g))
    sg = _sigmoid(y_g, t_g, 1.0 / (1.0 + t_g))
    t_c = torch.exp(-torch.abs(y_c))
    sp = torch.clamp_min(y_c, 0.0) + torch.log(1.0 + t_c)
    return sg * sp


def gate_grad_fast(y_g, y_c, dmsg):
    """(dL/dy_g, dL/dy_c) as kernel 5's ``gate_grad_fast``."""
    t_g = torch.exp(-torch.abs(y_g))
    sg = _sigmoid(y_g, t_g, 1.0 / (1.0 + t_g))
    t_c = torch.exp(-torch.abs(y_c))
    spg = _sigmoid(y_c, t_c, 1.0 / (1.0 + t_c))
    sp = torch.clamp_min(y_c, 0.0) + torch.log(1.0 + t_c)
    return dmsg * sg * (1.0 - sg) * sp, dmsg * sg * spg


def _halves(t, f):
    return t[..., :f], t[..., f:]


def apply_pass(z, mask, mean, rstd, scale, bias):
    """Kernel 3: y = (z - mean) * (rstd * scale) + bias, the gate summed
    over the slots in order, a padding slot's term selected to 0."""
    f = z.shape[-1] // 2
    y_g, y_c = _halves((z - mean) * (rstd * scale) + bias, f)
    msg = gate_fast(y_g, y_c)
    acc = torch.zeros_like(msg[:, 0])
    for s in range(z.shape[1]):
        acc = acc + torch.where(mask[:, s, None] > 0, msg[:, s], 0.0)
    return acc


def dz_pass(z, mask, mean, rstd, scale, bias, n_real, ct):
    """Kernels 4 then 5: the gradient sums over the real slots, then dz =
    rstd * (g * scale - (mean dxhat + xhat * mean(dxhat * xhat))), a
    padding slot's dz selected to 0. -> (dz, d_scale, d_bias)."""
    f = z.shape[-1] // 2
    real = mask[..., None] > 0
    xhat = (z - mean) * rstd
    y_g, y_c = _halves(xhat * scale + bias, f)
    g = torch.cat(gate_grad_fast(y_g, y_c, ct[:, None, :]), dim=-1)
    g = torch.where(real, g, 0.0)
    xs = torch.where(real, xhat, 0.0)
    dxhat = g * scale
    inv_c = 1.0 / max(float(n_real), 1.0)
    mdx = dxhat.sum(dim=(0, 1)) * inv_c
    mdxx = (dxhat * xs).sum(dim=(0, 1)) * inv_c
    dz = rstd * (g * scale - (mdx + xhat * mdxx))
    return (torch.where(real, dz, 0.0), (g * xs).sum(dim=(0, 1)),
            g.sum(dim=(0, 1)))


def _y(seed, dtype, shape=(6, 5, 2 * 9)):
    """y of a seeded normal spread, its first entries the domain edges."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0.0, 4.0, shape).astype(dtype)
    flat = y.reshape(-1)
    flat[: EDGES.size] = EDGES.astype(dtype)
    flat[EDGES.size: 2 * EDGES.size] = EDGES[::-1].astype(dtype)
    mask = (rng.random(shape[:2]) > 0.25).astype(dtype)
    mask[-1] = 0.0  # an all-padding row
    mask[0, :3] = 1.0  # the edges sit in real slots
    ct = rng.standard_normal((shape[0], shape[2] // 2)).astype(dtype)
    return y, mask, ct


def _nan_padding(a, mask):
    out = a.copy()
    out[mask == 0] = np.nan
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_exp_gate_matches_jax(seed, dtype):
    y, mask, _ = _y(seed, dtype)
    f = y.shape[-1] // 2
    want = np.asarray(jfe._gate(jnp.asarray(y), jnp.asarray(mask)))
    yt = torch.from_numpy(_nan_padding(y, mask))
    got = gate_fast(*_halves(yt, f))
    got = torch.where(torch.from_numpy(mask)[..., None] > 0, got, 0.0)
    assert got.dtype == yt.dtype
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    assert (got.numpy()[mask == 0] == 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_exp_gate_grad_matches_jax(seed, dtype):
    y, mask, ct = _y(seed, dtype)
    f = y.shape[-1] // 2
    want = np.asarray(jfe._gate_grad(jnp.asarray(y), jnp.asarray(mask),
                                     jnp.asarray(ct)))
    yt = torch.from_numpy(_nan_padding(y, mask))
    g = torch.cat(gate_grad_fast(*_halves(yt, f),
                                 torch.from_numpy(ct)[:, None, :]), dim=-1)
    g = torch.where(torch.from_numpy(mask)[..., None] > 0, g, 0.0)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("y", EDGES.tolist())
def test_one_exp_gate_at_each_edge(y):
    """Each edge value in f32 as the gate and as the core half, beside
    the JAX gate and its gradient (ct = 1, one real slot)."""
    pairs = np.array([[[y, 0.5], [-0.5, y]]], np.float32).reshape(1, 2, 2)
    mask = np.ones((1, 2), np.float32)
    ct = np.ones((1, 1), np.float32)
    want = np.asarray(jfe._gate(jnp.asarray(pairs), jnp.asarray(mask)))
    want_g = np.asarray(jfe._gate_grad(jnp.asarray(pairs),
                                       jnp.asarray(mask), jnp.asarray(ct)))
    yt = torch.from_numpy(pairs)
    got = gate_fast(*_halves(yt, 1))
    got_g = torch.cat(gate_grad_fast(*_halves(yt, 1), torch.ones(1, 1, 1)),
                      dim=-1)
    np.testing.assert_allclose(got.numpy(), want, **TOL[np.float32])
    np.testing.assert_allclose(got_g.numpy(), want_g, **TOL[np.float32])


SHAPES = [(7, 1, 4), (23, 5, 8), (40, 12, 20)]  # M 1 and 5: partial chunks


def _pass_inputs(shape, dtype, seed=0):
    n, m, f = shape
    rng = np.random.default_rng(seed)
    z = rng.normal(0.5, 1.5, (n, m, 2 * f)).astype(np.float32)
    mask = (rng.random((n, m)) > 0.3).astype(np.float32)
    mask[-2:] = 0.0  # all-padding rows
    mask[0, 0] = 1.0
    mean = rng.normal(0.5, 0.2, 2 * f).astype(np.float32)
    rstd = (1.0 / rng.uniform(1.2, 1.8, 2 * f)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 2 * f).astype(np.float32)
    bias = (0.2 * rng.standard_normal(2 * f)).astype(np.float32)
    ct = rng.standard_normal((n, f)).astype(np.float32)
    return [a.astype(dtype) for a in (z, mask, mean, rstd, scale, bias, ct)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_pass_matches_jax(shape, dtype):
    z, mask, mean, rstd, scale, bias, _ = _pass_inputs(shape, dtype)
    want = np.asarray(jfe._apply_xla(*map(jnp.asarray, (
        z, mask, mean, rstd, scale, bias))))
    t = [torch.from_numpy(a) for a in (_nan_padding(z, mask), mask, mean,
                                       rstd, scale, bias)]
    got = apply_pass(*t)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    assert (got.numpy()[-2:] == 0).all()
    # the port's plain version of kernel 3 on the same inputs
    cst = tfe.pack_cst(*t[2:6]).to(t[0].dtype)
    np.testing.assert_allclose(
        got.numpy(), tfe.epilogue_apply_reference(t[0], t[1], cst).numpy(),
        **TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_dz_pass_matches_jax(shape, dtype):
    z, mask, mean, rstd, scale, bias, ct = _pass_inputs(shape, dtype)
    n_real = mask.sum()
    want = [np.asarray(a) for a in jfe._bwd_xla(*map(jnp.asarray, (
        z, mask, mean, rstd, scale, bias, n_real, ct)))]
    t = [torch.from_numpy(a) for a in (_nan_padding(z, mask), mask, mean,
                                       rstd, scale, bias)]
    dz, d_scale, d_bias = dz_pass(*t, n_real, torch.from_numpy(ct))
    assert dz.dtype == t[0].dtype and torch.isfinite(dz).all()
    assert (dz.numpy()[mask == 0] == 0).all()
    for got, w in zip((dz, d_scale, d_bias), want):
        np.testing.assert_allclose(got.numpy(), w, **TOL[dtype])


def _aligned_ptrs(k, base=1 << 20):
    return tuple(base + 4096 * i for i in range(k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_width_for_every_f(dtype):
    """F = 1 .. 130: V is 1 or the 16-byte width (4 f32, 8 bf16) and
    divides F, the full width exactly where F allows it and every pointer
    is 16-byte aligned; one element's offset on any pointer takes the
    scalar path. A block is (F / V, rows) threads, kPassThreads = 256 of
    them where F / V <= 256, else (F, 1): never past 1024."""
    wide = tfe.VECTOR_WIDTH[dtype]
    assert wide * torch.empty(0, dtype=dtype).element_size() == 16
    for f in range(1, 131):
        for k in (3, 5):  # kernel 3's and kernel 5's vector pointers
            ptrs = _aligned_ptrs(k)
            v = tfe.vector_width(f, dtype, ptrs)
            assert v in (1, wide) and f % v == 0
            assert (v == wide) == (f % wide == 0), (f, v)
            tx = f // v
            assert tx * (1 if tx >= 256 else 256 // tx) <= 1024
            for i in range(k):
                for off in (2, 4, 8):  # one bf16, one f32, half a vector
                    bad = list(ptrs)
                    bad[i] += off
                    assert tfe.vector_width(f, dtype, bad) == 1, (f, i, off)
