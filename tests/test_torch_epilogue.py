"""The port's fused conv epilogue (ops/fused_epilogue.py) against the JAX
package's ``fused_epilogue``/``fused_epilogue_eval``: the Pallas kernels
run in interpret mode and the ``'xla'`` impl, on the same numpy z, mask
and BN parameters, forward and backward.

Tolerances are the JAX package's own for this op (tests/test_ops.py
``TestFusedEpilogue``): agg rtol 2e-5 / atol 2e-5 (f32, sums over M
reordered); mean and unbiased var rtol 1e-4 / atol 1e-5 (f32 one-pass
moments over every real slot); dz, d_scale, d_bias rtol 5e-4 / atol 5e-5
(the BN backward subtracts per-channel means of products, which loses a
few more f32 digits). The CUDA kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py); here their wrappers must
refuse what is not a CUDA tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cgnn_tpu.ops import fused_epilogue as jfe
from cgnn_tpu_torch.ops import fused_epilogue as tfe

AGG_TOL = dict(rtol=2e-5, atol=2e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _inputs(seed=0, n=67, m=12, f=32):
    """A ragged realistic mask: leading rows real with random slot counts,
    the last 7 node rows all padding."""
    rng = np.random.default_rng(seed)
    z = rng.normal(0.5, 1.5, size=(n, m, 2 * f)).astype(np.float32)
    mask = np.zeros((n, m), np.float32)
    for i in range(n - 7):
        mask[i, : rng.integers(3, m + 1)] = 1.0
    scale = rng.normal(1.0, 0.1, 2 * f).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 2 * f).astype(np.float32)
    ct = rng.standard_normal((n, f)).astype(np.float32)
    return z, mask, scale, bias, ct


def _jax_train(impl, z, mask, scale, bias, ct):
    def loss(z, scale, bias):
        agg, mean, var, n_real = jfe.fused_epilogue(
            z, jnp.asarray(mask), scale, bias, 1e-5, impl)
        return (agg * ct).sum(), (agg, mean, var, n_real)

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(z), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_train(impl, z, mask, scale, bias, ct):
    zt = torch.from_numpy(z).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    agg, mean, var, n_real = tfe.fused_epilogue(
        zt, torch.from_numpy(mask), st, bt, 1e-5, impl)
    (agg * torch.from_numpy(ct)).sum().backward()
    outs = [t.detach().numpy() for t in (agg, mean, var, n_real)]
    return outs, [t.grad.numpy() for t in (zt, st, bt)]


@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_fused_epilogue_matches_jax(jax_impl, port_impl):
    inp = _inputs()
    if jax_impl == "pallas":
        with pltpu.force_tpu_interpret_mode():
            want, want_g = _jax_train("pallas", *inp)
    else:
        want, want_g = _jax_train("xla", *inp)
    got, got_g = _torch_train(port_impl, *inp)
    np.testing.assert_allclose(got[0], want[0], **AGG_TOL)
    assert np.abs(got[0][-7:]).max() == 0.0  # all-padding rows sum nothing
    np.testing.assert_allclose(got[1], want[1], **STAT_TOL)
    np.testing.assert_allclose(got[2], want[2], **STAT_TOL)
    assert float(got[3]) == float(want[3])
    for a, b, name in zip(got_g, want_g, ("dz", "d_scale", "d_bias")):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)
    assert np.all(got_g[0][inp[1] == 0] == 0)  # padding slots get no dz


@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
def test_fused_epilogue_eval_matches_jax(port_impl):
    z, mask, scale, bias, _ = _inputs(seed=3)
    rng = np.random.default_rng(9)
    rmean = rng.normal(0, 1, z.shape[-1]).astype(np.float32)
    rvar = rng.uniform(0.5, 2.0, z.shape[-1]).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfe.fused_epilogue_eval(
            *(jnp.asarray(a) for a in (z, mask, scale, bias, rmean, rvar)),
            1e-5, "pallas"))
    got = tfe.fused_epilogue_eval(
        *(torch.from_numpy(a) for a in (z, mask, scale, bias, rmean, rvar)),
        1e-5, port_impl).numpy()
    np.testing.assert_allclose(got, want, **AGG_TOL)


def test_plain_passes_compose_to_autograd():
    """Kernels 4 and 5's plain versions give autograd's gradient of the
    masked-BN -> gate -> sum chain (taken here in f64; the plain versions
    compute in f32 as the JAX ones do: rtol 1e-4 / atol 1e-6)."""
    z, mask, scale, bias, ct = _inputs(seed=5, n=20, m=6, f=8)
    zt = torch.from_numpy(z).double().requires_grad_()
    st = torch.from_numpy(scale).double().requires_grad_()
    bt = torch.from_numpy(bias).double().requires_grad_()
    m = torch.from_numpy(mask).double()
    n_real = m.sum()
    mean = (zt * m[..., None]).sum((0, 1)) / n_real
    var = (((zt - mean) ** 2) * m[..., None]).sum((0, 1)) / n_real
    y = (zt - mean) * torch.rsqrt(var + 1e-5) * st + bt
    msg = torch.sigmoid(y[..., :8]) * tfe.softplus(y[..., 8:])
    ((msg * m[..., None]).sum(1) * torch.from_numpy(ct).double()).sum() \
        .backward()
    with torch.no_grad():
        cst = torch.stack([mean, torch.rsqrt(var + 1e-5), st, bt])
        dz, d_scale, d_bias = tfe.epilogue_backward(
            zt, m, cst, n_real, torch.from_numpy(ct).double(), "xla")
    for a, b in ((dz, zt.grad), (d_scale, st.grad), (d_bias, bt.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_padding_slots_are_selected_not_multiplied():
    """NaN in a masked slot of z must not reach the apply, reduce or dz
    pass: the kernels select padding slots to 0, and so do their plain
    versions. (The batch statistics, plain torch as in the JAX package,
    read only z's real slots when it comes from the model.)"""
    z, mask, scale, bias, ct = (torch.from_numpy(a) for a in _inputs(1))
    mean, var, n_real = tfe.masked_stats(z, mask)
    cst = tfe.pack_cst(mean, torch.rsqrt(var + 1e-5), scale, bias)
    poisoned = z.clone()
    poisoned[mask == 0] = float("nan")

    def passes(zz):
        dz, d_scale, d_bias = tfe.epilogue_backward(zz, mask, cst, n_real,
                                                    ct, "pallas")
        return (tfe.epilogue_apply(zz, mask, cst, "pallas"), dz, d_scale,
                d_bias)

    for a, b in zip(passes(z), passes(poisoned)):
        assert torch.isfinite(b).all()
        assert torch.equal(a, b)


def test_cuda_wrappers_refuse_non_cuda_tensors():
    z, mask, scale, bias, ct = (torch.from_numpy(a) for a in _inputs())
    cst = tfe.pack_cst(scale, scale, scale, bias)
    red5 = torch.zeros(5, z.shape[-1])
    calls = {
        tfe.epilogue_apply_cuda: (z, mask, cst),
        tfe.epilogue_reduce_cuda: (z, mask, cst, ct),
        tfe.epilogue_dz_cuda: (z, mask, cst, red5, ct),
    }
    before = [w.launches for w in calls]
    for wrapper, args in calls.items():
        with pytest.raises(ValueError, match="CUDA tensors"):
            wrapper(*args)
    # 'pallas' on a tensor that is not on the CPU takes the kernel route,
    # which raises: it never falls back to the plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfe.epilogue_apply(z.to("meta"), mask.to("meta"), cst.to("meta"),
                           "pallas")
    assert [w.launches for w in calls] == before
    with pytest.raises(ValueError, match="impl"):
        tfe.fused_epilogue(z, mask, scale, bias, 1e-5, "triton")


def test_module_keeps_bn1_names_and_updates_running_stats():
    z, mask, scale, bias, _ = _inputs(seed=2)
    mod = tfe.FusedBN1GateSum(z.shape[-1], impl="pallas")
    assert sorted(mod.state_dict()) == ["bias", "running_mean",
                                        "running_var", "weight"]
    mod.train()
    _, mean, var, n_real = tfe.fused_epilogue(
        torch.from_numpy(z), torch.from_numpy(mask), mod.weight, mod.bias)
    mod(torch.from_numpy(z), torch.from_numpy(mask))
    n = float(n_real)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               0.1 * mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               0.9 + 0.1 * var.numpy() * n / (n - 1),
                               rtol=1e-6)
    # an all-padding batch leaves them as they were
    before = mod.running_var.clone()
    mod(torch.from_numpy(z), torch.zeros_like(torch.from_numpy(mask)))
    assert torch.equal(mod.running_var, before)


def test_cost_model():
    n, m, f = 7000, 12, 64
    z_b = n * m * 2 * f * 4
    apply = tfe.epilogue_pass_cost("apply", n, m, f, real_slots=80000)
    dz = tfe.epilogue_pass_cost("dz", n, m, f, real_slots=80000)
    assert apply["bytes"] == z_b + n * m * 4 + 4 * 2 * f * 4 + n * f * 4
    assert dz["bytes"] == 2 * z_b + n * m * 4 + 9 * 2 * f * 4 + n * f * 4
    assert apply["flops"] == 5 * 80000 * 2 * f
