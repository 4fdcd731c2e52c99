"""K2a redesigned as one launch (`ops/groupnorm.py::group_stats`, run by
csrc/groupnorm_stats.cu) and the GroupNorm32 repair, on the CPU.

What the port runs here: `group_stats_plain` (what a CPU tensor takes) and
`GroupNorm32`'s `_GroupStats` (forward and closed-form gradient), held to
the JAX package on inputs made with numpy from a seed: `ChanStatsGroupNorm`
and `jax.grad` through it, `groupnorm_silu_xla` for the whole GN+SiLU, and
`_pallas_forward` in interpret mode at eps 1e-5 (it does not clip, so not at
eps 1e-6), at C in {32, 128, 224, 512, 1792} and eps 1e-5 and 1e-6.

Models of the kernel, not checks of it (no CUDA code runs here; the card's
checks are kernel_check's and chip_smoke.py's): `stats_plan`'s grid is
enumerated CTA by CTA and thread by thread to show that every (row, 16-byte
vector) is read exactly once and that the grid gives the H100's 132 SMs two
CTAs each wherever the rows allow; `_emulate` is a Python copy of the
kernel's order of summation (each thread's rows in order, with x^2 added by
a fused multiply-add, the CTA's row groups in order, the slabs in slab
order), in fp32, showing that this order stays within `kernel_check`'s 1e-5
bar of an fp64 sum, and that `kernel_check.clip_inputs` drives some group's
variance below 0 in it (so the clip check on the card exercises the clip).
Both take their constants from `stats_plan` only; if csrc/groupnorm_stats.cu's
layout or order changes, they must change with it."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nshmc_tpu.models.nn import ChanStatsGroupNorm
from nshmc_tpu.ops.groupnorm import _pallas_forward, groupnorm_silu_xla
from nshmc_tpu_torch.models.nn import GroupNorm32, nchw
from nshmc_tpu_torch.models.unet import UNetConfig, UNetModel
from nshmc_tpu_torch.ops import groupnorm as gn
from nshmc_tpu_torch.scripts import kernel_check as kc

torch.set_num_threads(2)
SMS = 132  # the H100's SMs
DTYPES = {"bf16": 2, "f32": 4}
CHANNELS = (32, 128, 224, 512, 1792)
EPS = (1e-5, 1e-6)


def _inputs(c, b=2, hw=4, seed=0):
    rng = np.random.default_rng(seed + c)
    x = (rng.standard_normal((b, hw, hw, c)) * 1.5 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


def _norm32(c, eps, scale, bias):
    mod = GroupNorm32(c, eps=eps)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    return mod


def _jax_norm(eps, scale, bias):
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    mod = ChanStatsGroupNorm(num_groups=32, epsilon=eps)
    return lambda x: mod.apply(params, x)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("c", CHANNELS)
def test_groupnorm32_matches_chan_stats_groupnorm(c, eps):
    """GroupNorm32 (statistics by `group_stats`, CPU: its plain version)
    against ChanStatsGroupNorm, f32: atol 2e-5 (fp32 sums in other orders,
    O(1) outputs)."""
    x, scale, bias = _inputs(c)
    out = _norm32(c, eps, scale, bias)(nchw(torch.from_numpy(x)))
    ref = _jax_norm(eps, scale, bias)(jnp.asarray(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                               atol=2e-5)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("c", CHANNELS)
def test_groupnorm32_grad_matches_jax(c, eps):
    """The input gradient through `_GroupStats`' closed-form backward and the
    plain affine against `jax.grad` through ChanStatsGroupNorm, for a
    cotangent that reaches both the mean and the inverse std: atol 1e-4,
    rtol 1e-4 (gradients up to ~30, fp32 sums in other orders)."""
    x, scale, bias = _inputs(c, seed=1)
    w = np.random.default_rng(2).standard_normal((1, 1, 1, c)).astype(np.float32)
    xt = nchw(torch.from_numpy(x)).requires_grad_(True)
    y = _norm32(c, eps, scale, bias)(xt).permute(0, 2, 3, 1)
    (g,) = torch.autograd.grad((y ** 2).sum() + (y * torch.from_numpy(w)).sum(), xt)
    f = _jax_norm(eps, scale, bias)
    ref = jax.grad(lambda a: jnp.sum(f(a) ** 2) + jnp.sum(f(a) * w))(jnp.asarray(x))
    np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("c", CHANNELS)
def test_groupnorm_silu_on_group_stats_matches_xla(c, eps):
    """The whole GN+SiLU (statistics by `group_stats`, then K2b's plain
    version) against groupnorm_silu_xla, f32, atol 1e-5."""
    x, scale, bias = _inputs(c, seed=3)
    out = gn.groupnorm_silu(*map(torch.from_numpy, (x, scale, bias)), 32, eps).numpy()
    ref = groupnorm_silu_xla(*map(jnp.asarray, (x, scale, bias)), 32, eps)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("c", CHANNELS)
def test_group_stats_plain_matches_the_pallas_stats_at_eps_1e5(c):
    """The port's GN+SiLU on `group_stats_plain`'s statistics against
    `_pallas_forward` (the Pallas stats kernel, the XLA group combine and
    the Pallas norm kernel) in interpret mode, f32, eps 1e-5, atol 1e-5;
    (1, 32, 32, C) is two 512-row blocks of the stats kernel."""
    x, scale, bias = _inputs(c, b=1, hw=32, seed=4)
    sums, mean_c, inv_c = gn.group_stats_plain(torch.from_numpy(x).reshape(1, -1, c))
    out = gn.normalize_silu_plain(torch.from_numpy(x).reshape(1, -1, c), mean_c, inv_c,
                                  torch.from_numpy(scale), torch.from_numpy(bias))
    with pltpu.force_tpu_interpret_mode():
        ref = _pallas_forward(*map(jnp.asarray, (x, scale, bias)), 32, 1e-5, interpret=True)
    np.testing.assert_allclose(out.reshape(x.shape).numpy(), np.asarray(ref), atol=1e-5)
    xf = x.reshape(1, -1, c).astype(np.float64)
    np.testing.assert_allclose(sums.numpy(), np.stack([xf.sum(1), (xf * xf).sum(1)], 1),
                               rtol=1e-5, atol=1e-3)


def _stats_grad(x, eps, wm, wi):
    """(d/dx of sum(mean_c * wm + inv_c * wi) through `_GroupStats`, mean_c, inv_c)."""
    from nshmc_tpu_torch.models.nn import _GroupStats

    xa = x.clone().requires_grad_(True)
    m, i = _GroupStats.apply(xa, 32, eps)
    return torch.autograd.grad((m * wm).sum() + (i * wi).sum(), xa)[0], m, i


def test_group_stats_backward_is_the_gradient_of_the_plain_composite():
    """`_GroupStats`' closed-form gradient against autograd through the same
    statistics in fp64 (group means, E[x^2] - mean^2, clip, rsqrt), within
    1e-5 of the largest gradient; its forward equals `group_combine` of the
    plain sums bit for bit."""
    gen = torch.Generator().manual_seed(5)
    x = 1.5 * torch.randn((2, 64, 64), generator=gen) + 0.3
    wm, wi = torch.randn((2, 2, 64), generator=gen)
    got, m, i = _stats_grad(x, 1e-5, wm, wi)
    m2, i2 = gn.group_combine(gn.channel_stats_plain(x), 64, 32, 1e-5)
    assert torch.equal(m, m2) and torch.equal(i, i2)
    xd = x.double().requires_grad_(True)
    xg = xd.reshape(2, 64, 32, 2)
    mean = xg.mean(dim=(1, 3))
    inv = torch.rsqrt(((xg * xg).mean(dim=(1, 3)) - mean ** 2).clamp(min=0) + 1e-5)
    loss = (mean.repeat_interleave(2, 1) * wm).sum() + (inv.repeat_interleave(2, 1) * wi).sum()
    (want,) = torch.autograd.grad(loss, xd)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_group_stats_backward_passes_nothing_through_an_active_clip():
    """At eps 1e-6 on `kernel_check.clip_inputs` the plain fp32 sums round
    some groups' variance below 0: there the gradient is that of the mean
    alone (the inverse std's cotangent changes nothing), and finite
    everywhere."""
    gen = torch.Generator().manual_seed(6)
    x = kc.clip_inputs((2, 4096, 64), torch.bfloat16, "cpu").float()
    clipped = (gn.group_moments(gn.channel_stats_plain(x), 4096)[1] < 0).repeat_interleave(2, 1)
    assert clipped.any() and not clipped.all()
    wm, wi = torch.randn((2, 2, 64), generator=gen)
    both, _, _ = _stats_grad(x, 1e-6, wm, wi)
    mean_only, _, _ = _stats_grad(x, 1e-6, wm, torch.zeros_like(wi))
    assert torch.isfinite(both).all()
    sel = clipped[:, None, :].expand_as(both)
    assert torch.equal(both[sel], mean_only[sel])
    assert not torch.equal(both[~sel], mean_only[~sel])


def test_groupnorm32_refuses_other_devices_and_counts_no_launch_on_cpu():
    mod = GroupNorm32(64)
    before = gn.group_stats.launches
    mod(torch.randn(1, 64, 4, 4))
    assert gn.group_stats.launches == gn.channel_stats.launches == before
    with pytest.raises(ValueError):
        GroupNorm32(64).to("meta")(torch.empty(1, 64, 4, 4, device="meta"))
    with pytest.raises(ValueError):
        gn.group_stats(torch.empty(1, 16, 64, device="meta"))


def test_group_stats_and_channel_stats_share_one_count():
    saved = gn.group_stats.launches
    try:
        gn.channel_stats.launches = 7
        assert gn.group_stats.launches == 7
        gn.group_stats.launches += 1
        assert gn.channel_stats.launches == 8
    finally:
        gn.group_stats.launches = saved


def test_flagship_groupnorm32_sites():
    """The flagship U-Net's GroupNorm32 sites (configs/ffhq.yaml: one an
    attention block, at ds16 and ds32), counted at ch 128 cut to 32 and
    batch 1 by forward hooks."""
    import yaml

    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "ffhq.yaml")) as f:
        cfg = UNetConfig.from_model_yaml(**yaml.safe_load(f)["model"])
    model = UNetModel(dataclasses.replace(cfg, model_channels=32)).eval()
    x = torch.zeros((1, cfg.image_size, cfg.image_size, 3))
    with torch.no_grad():
        _, attn, norm = kc.count_sites(model, lambda: model(x, torch.full((1,), 500.0)))
    assert {(8, r, c * 4): n for (_, r, c), n in norm.items()} == kc.FLAGSHIP_NORM_SITES
    assert sum(attn.values()) == sum(kc.FLAGSHIP_NORM_SITES.values())


# ---- the launch plan ----------------------------------------------------------------------


def _all_shapes():
    return list(dict.fromkeys([*kc.FLAGSHIP_GN_SITES, *kc.FLAGSHIP_NORM_SITES, *kc.GN_SHAPES,
                               *kc.VQ_DECODER_GN_SITES, *kc.VQ_DECODER_NORM_SITES,
                               *kc.LATENT_UNET_GN_SITES, *kc.LATENT_UNET_NORM_SITES]))


CASES = [(s, d) for s in _all_shapes() for d in DTYPES]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("shape,dtype", CASES, ids=[f"{s}-{d}" for s, d in CASES])
def test_plan_reads_every_element_once_and_fills_the_card(shape, dtype):
    b, r, c = shape
    elem = DTYPES[dtype]
    vec = 16 // elem
    cv = c // vec
    p = gn.stats_plan(b, r, c, elem, SMS)
    # the launcher's limits (csrc/groupnorm_stats.cu nshmc_gn_stats)
    assert c % 8 == 0 and c % gn.NUM_GROUPS == 0 and c <= gn.STATS_MAX_C
    assert 1 <= p.cbv <= gn.STATS_THREADS and p.n_cb <= 65535
    assert p.cbv * p.n_cb >= cv > p.cbv * (p.n_cb - 1)
    assert 1 <= p.slabs <= r and r * (c // gn.NUM_GROUPS) < 1 << 24
    rpi = gn.STATS_THREADS // p.cbv
    assert p.rows_per_pass == rpi
    assert rpi * p.cbv * vec <= 2048  # the row-group reduction's shared floats
    assert p.ctas == b * p.n_cb * p.slabs
    # every (row, vector) of a batch element read by exactly one thread: CTA
    # (slab s, channel block cb), thread (lane, r_off) reads vector cb * cbv +
    # lane of rows r0 + r_off, + rpi, ... below the slab's end
    seen = np.zeros((r, cv), np.int32)
    for cb in range(p.n_cb):
        v0 = cb * p.cbv
        vecs = np.arange(v0, min(cv, v0 + p.cbv))
        for s in range(p.slabs):
            rows = p.slab_rows(r, s)
            assert len(rows) >= min(r, rpi * gn.STATS_UNROLL)  # at least one unrolled pass
            for r_off in range(rpi):
                seen[np.ix_(np.arange(rows.start + r_off, rows.stop, rpi), vecs)] += 1
    assert (seen == 1).all()
    # two CTAs on every SM wherever slabs of one unrolled pass allow them,
    # and never more on some SMs than on others
    if b * p.n_cb * (r // (rpi * gn.STATS_UNROLL)) >= 2 * SMS:
        assert p.ctas >= 2 * SMS
    assert p.ctas <= 2 * SMS + b * p.n_cb


def test_plan_at_the_targets():
    """The hot shape in bf16: 16 vectors a row, 16 rows a pass, 33 slabs of
    1,985-1,986 rows, 264 CTAs (two an SM); the VQ decoder's (8, 4096, 512)
    in f32: rows of 128 vectors, 33 slabs; f32 rows wider than 256 vectors
    (the latent U-Net's 1120-1792 channels) cut in two."""
    hot = gn.stats_plan(8, 65536, 128, 2, SMS)
    assert (hot.cbv, hot.rows_per_pass, hot.slabs, hot.ctas) == (16, 16, 33, 264)
    assert {len(hot.slab_rows(65536, s)) for s in range(33)} == {1985, 1986}
    vq = gn.stats_plan(8, 4096, 512, 4, SMS)
    assert (vq.cbv, vq.rows_per_pass, vq.slabs) == (128, 2, 33)
    assert gn.stats_plan(8, 64, 1792, 4, SMS).n_cb == 2
    assert gn.stats_plan(8, 64, 1792, 2, SMS).n_cb == 1


def _emulate(x, plan):
    """The kernel's order of summation for one batch element: x (R, k)
    fp32 columns -> (2, k) fp32 [sum x, sum x^2]. Each thread adds its rows
    in order (x^2 by a fused multiply-add: the exact square in fp64, rounded
    once with the sum), the CTA its row groups in order, the last CTA the
    slabs in slab order. Rows a thread does not reach are zeros here, which
    leave a sum as it is."""
    r, k = x.shape
    rpi = plan.rows_per_pass
    t, t2 = np.zeros((plan.slabs, k), np.float32), np.zeros((plan.slabs, k), np.float32)
    for s in range(plan.slabs):
        rows = plan.slab_rows(r, s)
        n = -(-len(rows) // rpi)
        xs = np.zeros((n * rpi, k), np.float32)
        xs[:len(rows)] = x[rows.start:rows.stop]
        xs = xs.reshape(n, rpi, k)
        a, a2 = np.zeros((rpi, k), np.float32), np.zeros((rpi, k), np.float32)
        for j in range(n):
            a = a + xs[j]
            a2 = (a2.astype(np.float64) + xs[j].astype(np.float64) ** 2).astype(np.float32)
        for g in range(rpi):
            t[s], t2[s] = t[s] + a[g], t2[s] + a2[g]
    tot, tot2 = np.zeros(k, np.float32), np.zeros(k, np.float32)
    for s in range(plan.slabs):
        tot, tot2 = tot + t[s], tot2 + t2[s]
    return np.stack([tot, tot2])


@pytest.mark.parametrize("shape,dtype", CASES, ids=[f"{s}-{d}" for s, d in CASES])
def test_kernel_summation_order_is_within_the_bar(shape, dtype):
    """The emulated order against an fp64 sum within 1e-5 x max|sum|, for
    one batch element and eight channels of each channel block (a channel's
    order depends only on the rows a pass and the slabs)."""
    b, r, c = shape
    p = gn.stats_plan(b, r, c, DTYPES[dtype], SMS)
    per_block = p.cbv * (16 // DTYPES[dtype])
    cols = sorted({min(c - 1, cb * per_block + j) for cb in range(p.n_cb) for j in range(8)}
                  | {c - 1})
    rng = np.random.default_rng(r + c)
    x = torch.from_numpy((1.5 * rng.standard_normal((r, len(cols))) + 0.3).astype(np.float32))
    x = x.to(torch.bfloat16 if dtype == "bf16" else torch.float32).float().numpy()
    got = _emulate(x, p)
    xd = x.astype(np.float64)
    ref = np.stack([xd.sum(0), (xd * xd).sum(0)])
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_clip_inputs_drive_a_variance_below_zero_in_the_kernels_order(dtype):
    """kernel_check's clip case: in the kernel's order of summation some
    group's E[x^2] - E[x]^2 rounds below 0 at (8, 4096, 512) (two batch
    elements emulated), so the card's clip check exercises the clip."""
    shape = (8, 4096, 512)
    p = gn.stats_plan(*shape, dtype.itemsize, SMS)
    x = kc.clip_inputs(shape, dtype, "cpu")[:2].float().numpy()
    sums = torch.from_numpy(np.stack([_emulate(xb, p) for xb in x]))
    mean, var = gn.group_moments(sums, shape[1])
    assert (var < 0).any()
    _, inv = gn.group_combine(sums, shape[1], gn.NUM_GROUPS, 1e-6)
    assert torch.isfinite(inv).all()


def test_stats_counters_are_zeroed_once_and_grow_on_demand():
    dev = torch.device("cpu")
    gn._stats_counter_bufs.pop(dev, None)
    try:
        a = gn._stats_counters(dev, 8)
        assert a.dtype == torch.int32 and a.numel() >= 8 and not a.any()
        assert gn._stats_counters(dev, 100) is a
        b = gn._stats_counters(dev, a.numel() + 1)
        assert b is not a and not b.any() and b.numel() > a.numel()
        assert gn._stats_counters(dev, 8) is not gn._bwd_counters(dev, 8)
    finally:
        gn._stats_counter_bufs.pop(dev, None)
        gn._bwd_counter_bufs.pop(dev, None)
