"""nshmc_tpu_torch kernels' plain versions (what a CPU tensor runs) against
the JAX package's Pallas kernels in interpret mode and their XLA
references: attention (K1) and GroupNorm+SiLU (K2). Inputs from numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nshmc_tpu.models.nn import ChanStatsGroupNorm
from nshmc_tpu.ops.attention import attention_pallas, attention_xla
from nshmc_tpu.ops.groupnorm import groupnorm_silu as jax_groupnorm_silu
from nshmc_tpu.ops.groupnorm import groupnorm_silu_xla
from nshmc_tpu_torch.models.nn import GroupNormSiLU
from nshmc_tpu_torch.ops import attention as attn_mod
from nshmc_tpu_torch.ops import groupnorm as gn_mod

torch.set_num_threads(2)

ATTN_CASES = [(64, 16), (64, 64), (256, 16), (256, 64)]  # (T, ch), H = 2


def _qkv(t, ch, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, ch)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t,ch", ATTN_CASES)
def test_attention_forward_matches_jax(t, ch):
    q, k, v = _qkv(t, ch)
    out = attn_mod.attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = np.asarray(attention_xla(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(out, ref, atol=2e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(attention_pallas(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(out, pallas, atol=2e-5)


@pytest.mark.parametrize("t,ch", ATTN_CASES)
def test_attention_grad_matches_jax(t, ch):
    q, k, v = _qkv(t, ch, seed=1)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    loss = (attn_mod.attention(*ts) ** 2).sum()
    grads = torch.autograd.grad(loss, ts)
    ref = jax.grad(lambda a: jnp.sum(attention_xla(*a) ** 2))(
        tuple(map(jnp.asarray, (q, k, v))))
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3)


def test_attention_qkv_split_views():
    """q, k, v as strided views of one heads-major (B, T, H, 3, ch) qkv
    tensor give what contiguous copies give."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 2, 3, 16)).astype(np.float32))
    views = [qkv[..., i, :] for i in range(3)]
    np.testing.assert_array_equal(attn_mod.attention(*views).numpy(),
                                  attn_mod.attention(*[v.contiguous() for v in views]).numpy())


def test_attention_bf16_rounds_like_pallas():
    """In bf16 the port rounds where `_attn_kernel` does: q and k scaled in
    bf16, softmax weights cast to bf16 before the PV product. The Pallas
    kernel runs in interpret mode with XLA's excess precision off, so its
    bf16 casts are kept as written. Then all but a few output elements are
    equal, and none is off by more than one bf16 ulp plus 2^-12 (outputs
    near 0 come from cancellation); dropping either rounding changes about
    half of them."""
    q, k, v = _qkv(256, 64, seed=3)
    out = attn_mod.attention(*[torch.from_numpy(a).bfloat16() for a in (q, k, v)])
    assert out.dtype == torch.bfloat16
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        kernel = jax.jit(attention_pallas).lower(*jb).compile(
            compiler_options={"xla_allow_excess_precision": False})
        ref = np.asarray(kernel(*jb), np.float32)
    got = out.float().numpy()
    diff = np.abs(got - ref)
    assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)
    ulp = 2.0**-7 * np.maximum(np.abs(got), np.abs(ref))  # at most one bf16 ulp
    assert np.all(diff <= ulp + 2.0**-12), diff.max()


def _gn_inputs(b=2, h=8, w=8, c=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32) * 1.5 + 0.3
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 32, 32, 64), (2, 16, 16, 128)])
def test_groupnorm_silu_forward_matches_jax(shape):
    """(1, 32, 32, 64) is two 512-row blocks of the Pallas stats kernel."""
    x, scale, bias = _gn_inputs(*shape)
    out = gn_mod.groupnorm_silu(*map(torch.from_numpy, (x, scale, bias))).numpy()
    jx = tuple(map(jnp.asarray, (x, scale, bias)))
    np.testing.assert_allclose(out, np.asarray(groupnorm_silu_xla(*jx)), atol=1e-5)
    pallas = jax_groupnorm_silu(*jx, 32, 1e-5, True)  # interpret mode
    np.testing.assert_allclose(out, np.asarray(pallas), atol=1e-5)


def test_groupnorm_silu_grad_matches_jax():
    x, scale, bias = _gn_inputs(1, 4, 4, 64, seed=2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    grads = torch.autograd.grad((gn_mod.groupnorm_silu(*ts) ** 2).sum(), ts)
    ref = jax.grad(lambda a: jnp.sum(groupnorm_silu_xla(*a) ** 2))(
        tuple(map(jnp.asarray, (x, scale, bias))))
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_groupnorm_silu_bf16():
    x, scale, bias = _gn_inputs(c=64, seed=3)
    out = gn_mod.groupnorm_silu(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                                torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    ref = groupnorm_silu_xla(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                             jnp.asarray(bias))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=0.05)


def test_scale_shift_affine_matches_jax_resblock_out_norm():
    """Per-(batch, channel) affine = the JAX ResBlock's scale-shift path
    GN -> h * (1 + scale) + shift -> SiLU (nshmc_tpu/models/unet.py:170-177),
    in f32, through the port's GroupNormSiLU module."""
    x, gamma, beta = _gn_inputs(2, 8, 8, 64, seed=4)
    rng = np.random.default_rng(5)
    scale = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    shift = (rng.standard_normal((2, 64)) * 0.3).astype(np.float32)
    gn = ChanStatsGroupNorm(num_groups=32, epsilon=1e-5)
    h = gn.apply({"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}},
                 jnp.asarray(x))
    h = h * (1 + scale[:, None, None, :]) + shift[:, None, None, :]
    ref = np.asarray(jax.nn.silu(h))

    mod = GroupNormSiLU(64)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = mod(x_nchw, torch.from_numpy(scale), torch.from_numpy(shift))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), ref, atol=1e-5)


def test_cpu_takes_plain_path_and_counts_no_launch():
    counters = (attn_mod.attention_forward, *attn_mod.KERNEL_LAUNCHES.values(),
                gn_mod.channel_stats, gn_mod.group_stats, gn_mod.normalize_silu)
    before = [f.launches for f in counters]
    q = torch.randn(1, 64, 2, 16)
    attn_mod.attention(q, q, q)
    attn_mod.attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    gn_mod.groupnorm_silu(torch.randn(1, 4, 4, 32), torch.ones(32), torch.zeros(32))
    gn_mod.group_stats(torch.randn(1, 16, 32))
    assert [f.launches for f in counters] == before


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; a non-CUDA accelerator
    tensor is refused instead of being computed some other way."""
    q = torch.empty(1, 64, 2, 16, device="meta")
    with pytest.raises(ValueError):
        attn_mod.attention_forward(q, q, q)
    x = torch.empty(1, 16, 32, device="meta")
    with pytest.raises(ValueError):
        gn_mod.channel_stats(x)
    with pytest.raises(ValueError):
        gn_mod.group_stats(x)
    with pytest.raises(ValueError):
        gn_mod.normalize_silu(x, x[:, 0], x[:, 0], x[0, 0], x[0, 0])
