"""The GroupNorm+SiLU backward of nshmc_tpu_torch (kernel K2c): its plain
version, the closed form a CPU tensor runs, against the JAX package's
custom-VJP backward (`jax.vjp` of `groupnorm_silu_xla`, what `_gn_bwd`
computes) and the JAX ResBlock's scale-shift path, and the
autograd.Function around it. Inputs from numpy with a seed; f32 at the
port's bar, atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nshmc_tpu.models.nn import ChanStatsGroupNorm
from nshmc_tpu.ops.groupnorm import groupnorm_silu_xla
from nshmc_tpu_torch.models.nn import GroupNormSiLU
from nshmc_tpu_torch.ops import groupnorm as gn_mod

torch.set_num_threads(2)
ATOL = 1e-4


def _inputs(b, h, w, c, seed, per_batch_affine=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32) * 1.5 + 0.3
    shape = (b, c) if per_batch_affine else (c,)
    scale = (rng.standard_normal(shape) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return x, scale, bias, g


def _closed_form(x, scale, bias, g):
    """groupnorm_silu_backward_plain on NHWC numpy inputs, with the
    statistics the forward saves."""
    b, c = x.shape[0], x.shape[-1]
    x3 = torch.from_numpy(x).reshape(b, -1, c)
    mean_c, inv_c = gn_mod.group_combine(gn_mod.channel_stats_plain(x3), x3.shape[1])
    dx, dscale, dbias = gn_mod.groupnorm_silu_backward_plain(
        x3, torch.from_numpy(g).reshape(x3.shape), mean_c, inv_c,
        torch.from_numpy(scale), torch.from_numpy(bias))
    return dx.reshape(x.shape).numpy(), dscale.numpy(), dbias.numpy()


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 32, 32, 64), (2, 16, 16, 128),
                                   (2, 8, 8, 32)])  # the last: C = 32, one channel a group
def test_closed_form_matches_jax_vjp(shape):
    x, scale, bias, g = _inputs(*shape, seed=sum(shape))
    _, vjp = jax.vjp(groupnorm_silu_xla, *map(jnp.asarray, (x, scale, bias)))
    ref = vjp(jnp.asarray(g))
    for got, want in zip(_closed_form(x, scale, bias, g), ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_per_batch_affine_matches_jax_resblock_scale_shift():
    """The per-(batch, channel) affine through the port's GroupNormSiLU
    module (gamma * (1 + s), beta * (1 + s) + shift folded in torch, then
    the Function's backward) against jax.vjp of the JAX ResBlock's
    scale-shift path ChanStatsGroupNorm -> h * (1 + s) + shift -> silu
    (nshmc_tpu/models/unet.py:170-177), for x, gamma, beta, s and shift."""
    x, gamma, beta, g = _inputs(2, 8, 8, 64, seed=7)
    rng = np.random.default_rng(8)
    s = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    shift = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    norm = ChanStatsGroupNorm(num_groups=32, epsilon=1e-5)

    def jax_path(x, gamma, beta, s, shift):
        h = norm.apply({"params": {"scale": gamma, "bias": beta}}, x)
        return jax.nn.silu(h * (1 + s[:, None, None, :]) + shift[:, None, None, :])

    _, vjp = jax.vjp(jax_path, *map(jnp.asarray, (x, gamma, beta, s, shift)))
    ref = vjp(jnp.asarray(g))

    mod = GroupNormSiLU(64)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
    xt, st_, sh = (torch.from_numpy(a).requires_grad_(True) for a in (x, s, shift))
    out = mod(xt.permute(0, 3, 1, 2), st_, sh).permute(0, 2, 3, 1)
    grads = torch.autograd.grad(out, [xt, mod.weight, mod.bias, st_, sh],
                                torch.from_numpy(g))
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("per_batch_affine", [False, True])
def test_function_backward_is_the_closed_form(per_batch_affine):
    x, scale, bias, g = _inputs(2, 8, 8, 64, seed=11, per_batch_affine=per_batch_affine)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    grads = torch.autograd.grad(gn_mod.groupnorm_silu(*ts), ts, torch.from_numpy(g))
    for got, want in zip(grads, _closed_form(x, scale, bias, g)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_function_returns_none_for_frozen_affine_and_counts_no_launch():
    """The U-Net's weights are frozen: only dx is asked for, the Function
    returns None for scale and bias, and a CPU tensor launches nothing."""
    x, scale, bias, g = _inputs(1, 4, 4, 32, seed=12)
    before = gn_mod.groupnorm_silu_backward.launches
    xt = torch.from_numpy(x).requires_grad_(True)
    y = gn_mod.groupnorm_silu(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    dx, dscale, dbias, *rest = y.grad_fn.apply(torch.from_numpy(g))
    assert dscale is None and dbias is None and rest == [None, None]
    np.testing.assert_array_equal(dx.detach().numpy(), _closed_form(x, scale, bias, g)[0])
    assert gn_mod.groupnorm_silu_backward.launches == before


def test_bf16_dx_is_the_f32_closed_form_rounded_once():
    """bf16 x and cotangent: every step runs in fp32 on the bf16 values and
    dx is rounded to bf16 once, so it lies within half a bf16 ulp
    (<= 2^-8 |dx|) of the f32 closed form on the same values; the affine
    gradients, fp32 sums, are equal."""
    x, scale, bias, g = _inputs(2, 16, 16, 64, seed=13)
    xb, gb = (torch.from_numpy(a).reshape(2, -1, 64).bfloat16() for a in (x, g))
    mean_c, inv_c = gn_mod.group_combine(gn_mod.channel_stats_plain(xb), xb.shape[1])
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    low = gn_mod.groupnorm_silu_backward_plain(xb, gb, mean_c, inv_c, sc, bi)
    ref = gn_mod.groupnorm_silu_backward_plain(xb.float(), gb.float(), mean_c, inv_c, sc, bi)
    assert low[0].dtype == torch.bfloat16
    dx, want = low[0].float().numpy(), ref[0].numpy()
    assert np.all(np.abs(dx - want) <= 2.0**-8 * np.abs(want))
    assert np.mean(dx != want) > 0.5  # the rounding happened
    for a, b_ in zip(low[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())


@settings(max_examples=25, deadline=None)
@given(b=st.integers(1, 3), r=st.integers(4, 40), k=st.integers(1, 4),
       per_batch_affine=st.booleans(), seed=st.integers(0, 2**16))
def test_closed_form_matches_autograd_of_plain(b, r, k, per_batch_affine, seed):
    """Any (B, R, C = 32 k) in f32: the closed form against autograd through
    the plain forward (the backward the port ran before K2c), within 1e-4
    of the largest gradient entry."""
    c = 32 * k
    x, scale, bias, g = _inputs(b, r, 1, c, seed, per_batch_affine)
    got = _closed_form(x, scale, bias, g)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    want = torch.autograd.grad(gn_mod.groupnorm_silu_plain(*ts), ts, torch.from_numpy(g))
    for a, w in zip(got, want):
        w = w.numpy()
        np.testing.assert_allclose(a, w, atol=ATOL * max(1.0, float(np.abs(w).max())))


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 16, 32, device="meta")
    stats = torch.empty(1, 32, device="meta")
    with pytest.raises(ValueError):
        gn_mod.groupnorm_silu_backward(x, x, stats, stats, stats[0], stats[0])


@pytest.mark.parametrize("b,r,c,elem,want", [
    (8, 65536, 128, 2, 1024),  # the hot shape: 64 slabs x 8 = 512 blocks
    (8, 4096, 256, 2, 64),     # halved until 8 x 64 = 512 blocks
    (8, 64, 512, 2, 16),       # 4 row steps of 4 rows: the floor
    (1, 256, 64, 4, 64),       # f32, 16 rows a step
])
def test_bwd_slab_rows(b, r, c, elem, want):
    assert gn_mod.bwd_slab_rows(b, r, c, elem, 132) == want


def test_kernel_check_cases_run_on_cpu():
    """The card checks of scripts/kernel_check.py at a tiny size on the CPU,
    where the wrappers take their plain versions: the control flow, not the
    kernels."""
    from nshmc_tpu_torch.scripts import kernel_check as kc

    gen, cpu = torch.Generator().manual_seed(0), torch.device("cpu")
    for dt in (torch.bfloat16, torch.float32):
        res = kc.attention_check(*kc.qkv_inputs((1, 5, 2, 16), dt, gen, cpu))
        assert res["ok"] and res["max_abs_err"] == 0
        for form in kc.AFFINE_FORMS:
            res = kc.gn_backward_check(*kc.gn_inputs((2, 9, 64), dt, form, gen, cpu))
            assert res["ok"] and res["dx_err"] == 0 and res["affine_rel_err"] == 0
