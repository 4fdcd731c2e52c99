"""Hold the main path's CUDA kernels K1 (attention), K2a (GroupNorm
statistics) and K2c (GroupNorm+SiLU backward) against their plain versions
on the card, without timing them.

    python -m nshmc_tpu_torch.scripts.kernel_check

It builds csrc/attention.cu, csrc/groupnorm_bwd.cu and
csrc/groupnorm_stats.cu, prints each
kernel's registers, spills and shared memory (nvcc -Xptxas -v), then
checks, on seeded random inputs:
  - K1 at the flagship's attention shapes (8, 256, 8, 64) and (8, 64, 8, 64),
    the latent U-Net's (LATENT_ATTN_SHAPES: 14, 21 and 28 heads of 32
    channels at 1024, 256 and 64 tokens), Stable Diffusion 2.1-base's
    (SD_ATTN_SITES: 5, 10, 20 and 20 heads of 64 at 4096, 1024, 256 and 64
    tokens), and edge shapes (2, T, 2, ch) for
    T in {1, 16, 100, 1000} and ch in {16, 32, 64}, in bf16 (the two-pass
    tensor-core kernel: its resident design up to 256 tokens, its TMA and
    wgmma design above, `attention.bf16_design`) and f32 (the one-pass
    3xTF32 tensor-core kernel);
  - K2c, both of its designs (the one launch and the two-pass one, each
    called directly, whichever the wrapper would pick), at the flagship's 18
    GN+SiLU shapes (FLAGSHIP_GN_SITES) and at GN_SHAPES (smaller and ragged
    ones), in bf16 and f32, with a (C,) and a (B, C) affine; each case also
    calls the design twice and requires bit-identical dx, dscale and dbias;
  - K2a (`group_stats`, one launch) at every K2a site of the three paths
    and GN_SHAPES (STATS_CASES: the GN+SiLU and GroupNorm32 sites, each at
    its eps), in bf16 and f32, and the variance clip at eps 1e-6;
  - K2c at the latent path's GN+SiLU shapes (LATENT_GN_SITES: the VQ
    decoder's at eps 1e-6, the latent U-Net's, with 7 to 56 channels a
    group), and in f32 at the same sites at batch 1 (BATCH1_GN_SITES, the
    ReSamples' gradients): each design that can take the call, and the
    wrapper, which cuts the f32 calls wider than 1024 channels into chunks
    of whole groups; K1 in f32 at the latent U-Net's batch-1 shapes;
  - K2a and K2c at the CelebA-HQ DDPM's 65 GN+SiLU sites (DDPM_GN_SITES,
    18 of the flagship's shapes at eps 1e-6) in bf16 and f32, and K2a at its
    GroupNorm32 sites and the conditional U-Net's SpatialTransformer norms
    (DDPM_NORM_SITES, COND_UNET_NORM_SITES, eps 1e-6).
Each case prints one line; the run exits 1 if any case disagrees. No time
is measured: this is the build-and-check step before a kernel is timed.
`chip_smoke.py` phase 3 uses the same checks at the main path's shapes.
Needs a CUDA card and nvcc.

Tolerances, with reasons:
  - K1 f32: 1e-4 absolute (fp32 sums in another order; 3xTF32 products
    keep about fp32 accuracy, one TF32 product would not: see
    tests/test_torch_attention_f32.py).
  - K1 bf16: every element within 2^-7 |y| + 2^-7 S + 2^-12, with
    S = sum_j w_j |v_j| over the plain version's bf16 weights, and at most
    5% of the elements differing at all. The tensor cores sum the fp32
    logits in another order than the plain version's matmul, so a weight
    whose fp32 value lies at a bf16 rounding midpoint can round to the other
    neighbour; that moves y by one bf16 ulp of w_j times |v_j|, at most
    2^-7 w_j |v_j|, and S bounds it for any set of such weights. 2^-7 |y| is
    the output's own rounding, 2^-12 covers outputs near 0 from
    cancellation. One bf16 ulp + 2^-12 alone does not hold for a change of
    summation order: the plain version with its logits summed in 16-channel
    chunks breaks it (tests/test_torch_attention_tc.py). Weights left
    unrounded stay within the per-element bound but change ~41% of the
    outputs, which the 5% limit refuses.
  - K2c dx bf16: 2^-7 |dx| + 2^-12 max|dx|. Both compute dx in fp32 and
    round once; their fp32 values differ in the order of the group sums and
    in FMA contraction, which can round to the neighbouring bf16 value;
    elements near 0 come from cancellation in gamma * da - (k1 + xh * k2).
  - K2c dx f32: 1e-4 absolute (dx is O(1) on these inputs).
  - K2c dscale, dbias: 1e-5 x max|ref|, fp32 sums of R values in another
    order (the stats kernels' bar).
  - K2a sums: 1e-5 x max|sum|, fp32 sums of R values in another order.
  - K2a mean_c within 1e-5 / inv_c (a hundred-thousandth of the group's
    standard deviation) and inv_c within 1e-5 relative of `group_combine`
    applied to the launch's own sums: the two add a group's <= 56 channel
    sums in other orders (each within 55 * 2^-24 of the sum of their
    magnitudes; E[x^2] - E[x]^2 passes that on to inv_c scaled by
    E[x^2] / var, ~1 on these inputs), and rsqrtf is within 2 ulp.
    Downstream, the GN+SiLU forward through the launch and K2b is held to
    K2b's bars: f32 1e-4 absolute, bf16 2^-7 |y| + 1e-3 (one bf16 rounding).
  - K2a's variance clip: finiteness only (see `gn_clip_check`).
"""
from __future__ import annotations

import sys
import threading

import torch

from ..ops import _build
from ..ops import attention as attn
from ..ops import groupnorm as gn
from ._bench import card, resolve_device

SOURCES = ("attention.cu", "groupnorm_bwd.cu", "groupnorm_stats.cu")
# the latent U-Net's attention blocks (configs/ffhq_latent.yaml, 8 chains):
# (B, T, heads, ch) at ds 2, 4, 8 -> blocks a forward
LATENT_ATTN_SITES = {(8, 1024, 14, 32): 5, (8, 256, 21, 32): 5, (8, 64, 28, 32): 6}
LATENT_ATTN_SHAPES = list(LATENT_ATTN_SITES)
# Stable Diffusion 2.1-base's self-attention (configs/sd21_base_latent.yaml, 8
# chains): (B, T, heads, ch) at ds 1, 2, 4 and the middle -> sites a forward
SD_ATTN_SITES = {(8, 4096, 5, 64): 5, (8, 1024, 10, 64): 5, (8, 256, 20, 64): 5,
                 (8, 64, 20, 64): 1}
ATTN_SHAPES = [(8, 256, 8, 64), (8, 64, 8, 64)] + LATENT_ATTN_SHAPES + list(SD_ATTN_SITES) + [
    (2, t, 2, ch) for t in (1, 16, 100, 1000) for ch in (16, 32, 64)]
GN_SHAPES = [(8, 65536, 128), (8, 16384, 256), (8, 1024, 512), (8, 64, 512), (3, 1000, 96),
             (1, 17, 32)]
# the flagship U-Net's GN+SiLU sites, (B, rows, C) at 8 chains -> sites a
# forward (configs/ffhq.yaml; 61 sites a forward over these 18 shapes)
FLAGSHIP_GN_SITES = {(8, 65536, 256): 2, (8, 65536, 128): 7, (8, 16384, 384): 1,
                     (8, 16384, 256): 2, (8, 16384, 128): 7, (8, 4096, 512): 1,
                     (8, 4096, 384): 1, (8, 4096, 256): 6, (8, 4096, 128): 2,
                     (8, 1024, 768): 1, (8, 1024, 512): 2, (8, 1024, 256): 7,
                     (8, 256, 1024): 1, (8, 256, 768): 1, (8, 256, 512): 6, (8, 256, 256): 2,
                     (8, 64, 1024): 2, (8, 64, 512): 10}
# the latent path's GN+SiLU sites, (B, rows, C) at 8 chains -> sites a
# forward (configs/ffhq_latent.yaml): the VQ decoder's 23, eps 1e-6 ...
VQ_DECODER_GN_SITES = {(8, 4096, 512): 10, (8, 16384, 512): 1, (8, 16384, 256): 5,
                       (8, 65536, 256): 1, (8, 65536, 128): 6}
# ... and the latent U-Net's 45 (eps 1e-5; the decoder half's inputs carry
# the skip channels: 448 to 1792)
LATENT_UNET_GN_SITES = {(8, 4096, 224): 8, (8, 4096, 448): 2, (8, 4096, 672): 1,
                        (8, 1024, 224): 1, (8, 1024, 448): 6, (8, 1024, 672): 1,
                        (8, 1024, 896): 1, (8, 1024, 1120): 1,
                        (8, 256, 448): 1, (8, 256, 672): 6, (8, 256, 1120): 1,
                        (8, 256, 1344): 1, (8, 256, 1568): 1,
                        (8, 64, 672): 1, (8, 64, 896): 10, (8, 64, 1568): 1, (8, 64, 1792): 2}
LATENT_GN_SITES = {"vq_decoder": (1e-6, VQ_DECODER_GN_SITES),
                   "latent_unet": (1e-5, LATENT_UNET_GN_SITES)}
# the same sites at batch 1, where ReSample differentiates the latent U-Net
# and both ReSamples' inner solves the VQ decoder, in f32 (7 to 56 channels
# a group); and K1 at the latent U-Net's batch-1 shapes
BATCH1_GN_SITES = {part: (eps, {(1, r, c): n for (_, r, c), n in sites.items()})
                   for part, (eps, sites) in LATENT_GN_SITES.items()}
BATCH1_ATTN_SHAPES = [(1, t, h, ch) for (_, t, h, ch) in LATENT_ATTN_SHAPES]
# the GroupNorm32 sites (an attention block's norm, no SiLU: K2a alone), (B,
# rows, C) -> sites a forward: the flagship U-Net's at ds16 and ds32, the
# latent U-Net's at ds 2, 4, 8 (eps 1e-5), the VQ decoder's mid-block
# AttnBlock (eps 1e-6)
FLAGSHIP_NORM_SITES = {(8, 256, 512): 3, (8, 64, 512): 1}
LATENT_UNET_NORM_SITES = {(8, 1024, 448): 5, (8, 256, 672): 5, (8, 64, 896): 6}
VQ_DECODER_NORM_SITES = {(8, 4096, 512): 1}
# the CelebA-HQ DDPM's (models/ddpm_simple.py, DDPMConfig's defaults: ch 128,
# mult 1,1,2,2,4,4, 2 ResBlocks a level, attention at 16, 256^2) GN+SiLU sites
# at 8 chains, eps 1e-6: 65 a forward over 18 shapes, each one of the
# flagship's (the decoder half's inputs carry the skip channels) ...
DDPM_EPS = 1e-6
DDPM_GN_SITES = {(8, 65536, 256): 3, (8, 65536, 128): 8, (8, 16384, 384): 1,
                 (8, 16384, 256): 2, (8, 16384, 128): 7, (8, 4096, 512): 2,
                 (8, 4096, 384): 1, (8, 4096, 256): 6, (8, 4096, 128): 1,
                 (8, 1024, 768): 1, (8, 1024, 512): 2, (8, 1024, 256): 7,
                 (8, 256, 1024): 2, (8, 256, 768): 1, (8, 256, 512): 6, (8, 256, 256): 1,
                 (8, 64, 1024): 3, (8, 64, 512): 11}
# ... and its 6 AttnBlock norms (GroupNorm32, K2a alone)
DDPM_NORM_SITES = {(8, 256, 512): 5, (8, 64, 512): 1}
# the conditional U-Net (configs/ffhq_latent.yaml's latent U-Net with
# context_dim set): a SpatialTransformer's GroupNorm32 at each of the latent
# U-Net's attention sites, eps 1e-6
COND_UNET_NORM_SITES = dict(LATENT_UNET_NORM_SITES)
# every (shape, eps) at which K2a runs on the paths, and GN_SHAPES
STATS_CASES = list(dict.fromkeys(
    [(s, 1e-5) for s in [*FLAGSHIP_GN_SITES, *FLAGSHIP_NORM_SITES, *GN_SHAPES]]
    + [(s, 1e-6) for s in [*VQ_DECODER_GN_SITES, *VQ_DECODER_NORM_SITES]]
    + [(s, 1e-5) for s in [*LATENT_UNET_GN_SITES, *LATENT_UNET_NORM_SITES]]
    + [(s, DDPM_EPS) for s in [*DDPM_GN_SITES, *DDPM_NORM_SITES, *COND_UNET_NORM_SITES]]))
GN_BWD_DESIGNS = {"one_launch": gn.launch_one, "twopass": gn.launch_twopass}
AFFINE_FORMS = ("per_channel", "per_batch_channel")


def count_sites(root: torch.nn.Module, fn):
    """Run fn() with forward hooks on every GroupNorm+SiLU, GroupNorm32 and
    U-Net attention block under `root`: ({(B, rows, C): GN+SiLU calls},
    {(B, T, heads, ch): attention blocks}, {(B, rows, C): GroupNorm32
    calls}). A module that activation checkpointing runs again counts
    again."""
    from ..models.nn import GroupNorm32, GroupNormSiLU
    from ..models.unet import AttentionBlock

    gn_sites, attn_sites, norm_sites = {}, {}, {}

    def counter(sites):
        def hook(mod, args, out):
            key = (args[0].shape[0], args[0].shape[2] * args[0].shape[3], args[0].shape[1])
            sites[key] = sites.get(key, 0) + 1
        return hook

    def attn_hook(mod, args, out):
        b, c, hh, ww = args[0].shape
        key = (b, hh * ww, mod.heads, c // mod.heads)
        attn_sites[key] = attn_sites.get(key, 0) + 1

    hooks = [m.register_forward_hook(counter(gn_sites)) for m in root.modules()
             if isinstance(m, GroupNormSiLU)]
    hooks += [m.register_forward_hook(counter(norm_sites)) for m in root.modules()
              if isinstance(m, GroupNorm32)]
    hooks += [m.register_forward_hook(attn_hook) for m in root.modules()
              if isinstance(m, AttentionBlock)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return gn_sites, attn_sites, norm_sites


def build_reports() -> dict:
    """nvcc for each source in its own thread; {source: ptxas lines}.
    Raises if any build fails."""
    reports, errors = {}, []

    def nvcc(src):
        try:
            reports[src] = _build.ptxas_summary(_build.build(src)[1])
        except Exception as e:  # reported after the join
            errors.append(f"{src}: {e}")

    threads = [threading.Thread(target=nvcc, args=(s,)) for s in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return reports


def qkv_inputs(shape, dtype, gen, device):
    """q, k, v as views of one seeded (B, T, H, 3, ch) tensor, as the U-Net
    passes them."""
    b, t, h, ch = shape
    qkv = torch.randn((b, t, h, 3, ch), generator=gen, device=device).to(dtype)
    return tuple(qkv[..., i, :] for i in range(3))


BF16_ATTN_TOL = "2^-7 |y| + 2^-7 sum_j w_j |v_j| + 2^-12, <= 5% of elements differ"


def bf16_attention_agreement(y, y_plain, w, v):
    """The bf16 K1 criterion (see the module note) for an output y against
    the plain output, given the plain bf16 weights w (B, H, T, T) and v:
    {ok, max_abs_err, beyond_one_ulp (elements past 2^-7 |y| + 2^-12),
    frac_differ}."""
    y, y_plain = y.float(), y_plain.float()
    diff = (y - y_plain).abs()
    spread = torch.einsum("bhts,bshc->bthc", w.float(), v.float().abs())
    frac = float((diff > 0).float().mean())
    ok = bool((diff <= 2 ** -7 * y_plain.abs() + 2 ** -7 * spread + 2 ** -12).all())
    return {"ok": ok and frac <= 0.05, "max_abs_err": float(diff.max()),
            "beyond_one_ulp": int((diff > 2 ** -7 * y_plain.abs() + 2 ** -12).sum()),
            "frac_differ": frac}


def attention_check(q, k, v):
    """K1 against attention_plain: {ok, max_abs_err, tolerance, and for bf16
    beyond_one_ulp and frac_differ}."""
    y = attn.attention_forward(q, k, v)
    y_plain = attn.attention_plain(q, k, v)
    if q.dtype == torch.float32:
        err = float((y - y_plain).abs().max())
        return {"ok": err <= 1e-4, "max_abs_err": err, "tolerance": "1e-4"}
    res = bf16_attention_agreement(y, y_plain, attn.attention_weights_plain(q, k, v.dtype), v)
    return {**res, "tolerance": BF16_ATTN_TOL}


def attention_summary(res) -> str:
    """One line of an attention_check result."""
    extra = (f", {res['beyond_one_ulp']} elements past one bf16 ulp + 2^-12, "
             f"{100 * res['frac_differ']:.3f}% differ" if "frac_differ" in res else "")
    return (f"max|kernel-plain| {res['max_abs_err']:.3e}{extra} (tol {res['tolerance']}): "
            f"{'ok' if res['ok'] else 'DISAGREES'}")


def gn_inputs(shape, dtype, form, gen, device, eps=gn.EPS):
    """x, the cotangent g, the forward's statistics and an affine, seeded."""
    b, r, c = shape
    x = (1.5 * torch.randn(shape, generator=gen, device=device) + 0.3).to(dtype)
    g = torch.randn(shape, generator=gen, device=device).to(dtype)
    mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r, gn.NUM_GROUPS, eps)
    aff = (c,) if form == "per_channel" else (b, c)
    scale = 1 + 0.3 * torch.randn(aff, generator=gen, device=device)
    bias = 0.3 * torch.randn(aff, generator=gen, device=device)
    return x, g, mean_c, inv_c, scale, bias


STATS_TOL = ("sums 1e-5 max|sum|; mean_c 1e-5 / inv_c, inv_c 1e-5 inv_c; GN+SiLU f32 1e-4, "
             "bf16 2^-7 |y| + 1e-3")


def gn_stats_check(x, num_groups=gn.NUM_GROUPS, eps=gn.EPS, gen=None):
    """K2a's one launch (`group_stats`) at x against its plain version (see
    the module note for the bars): the sums against `channel_stats_plain`;
    mean_c and inv_c against `group_combine` of the kernel's own sums; the
    whole GN+SiLU forward (the launch and K2b) against
    `groupnorm_silu_plain` with a seeded (B, C) affine; a second launch
    against the first. {ok, sums_abs, sums_rel, mean_err, inv_rel, apply_err,
    same_bits, tolerance}."""
    b, r, c = x.shape
    sums, mean_c, inv_c = gn.group_stats(x, num_groups, eps)
    again = gn.group_stats(x, num_groups, eps)
    ref = gn.channel_stats_plain(x)
    sums_abs = float((sums - ref).abs().max())
    sums_rel = sums_abs / float(ref.abs().max())
    m_ref, i_ref = gn.group_combine(sums, r, num_groups, eps)
    mean_err = float(((mean_c - m_ref).abs() * i_ref).max())
    inv_rel = float(((inv_c - i_ref).abs() / i_ref).max())
    scale = 1 + 0.3 * torch.randn((b, c), generator=gen, device=x.device)
    bias = 0.3 * torch.randn((b, c), generator=gen, device=x.device)
    y = gn.groupnorm_silu(x, scale, bias, num_groups, eps).float()
    y_ref = gn.groupnorm_silu_plain(x, scale, bias, num_groups, eps).float()
    diff = (y - y_ref).abs()
    tol = 1e-4 if x.dtype == torch.float32 else 2 ** -7 * y_ref.abs() + 1e-3
    same = all(torch.equal(u, v) for u, v in zip((sums, mean_c, inv_c), again))
    ok = (sums_rel <= 1e-5 and mean_err <= 1e-5 and inv_rel <= 1e-5
          and bool((diff <= tol).all()) and same)
    return {"ok": ok, "sums_abs": sums_abs, "sums_rel": sums_rel, "mean_err": mean_err,
            "inv_rel": inv_rel, "apply_err": float(diff.max()), "same_bits": same,
            "tolerance": STATS_TOL}


def clip_inputs(shape, dtype, device):
    """Groups with a large mean and a tiny spread (seeded): in f32 group g
    at 300.3 + 4g with a spread of 1e-3; in bf16 at 300 + 2g, one value in
    2,000 a bf16 step (2) above. E[x^2] - E[x]^2 is then a rounding error
    of the fp32 sums and falls below 0 in some groups, where rsqrt(var +
    eps) without the clip is NaN."""
    gen = torch.Generator(device=device).manual_seed(7)
    cg = shape[2] // gn.NUM_GROUPS
    g = torch.arange(gn.NUM_GROUPS, device=device).repeat_interleave(cg).float()
    if dtype == torch.float32:
        return 300.3 + 4 * g + 1e-3 * torch.randn(shape, generator=gen, device=device)
    step = (torch.rand(shape, generator=gen, device=device) < 5e-4).float()
    return (300 + 2 * g + 2 * step).to(dtype)


def gn_clip_check(dtype, device, shape=(8, 4096, 512), eps=1e-6):
    """The variance clip at eps 1e-6 on `clip_inputs`, at the VQ decoder's
    (8, 4096, 512). Only finiteness is asserted: the true variances lie far
    below the rounding of the fp32 sums, so no two orders of summation need
    agree on them. {ok, finite, negative_groups}: ok needs finite mean_c
    and inv_c and at least one group whose variance from the launch's own
    sums is below 0 (the clip was exercised)."""
    x = clip_inputs(shape, dtype, device)
    sums, mean_c, inv_c = gn.group_stats(x, gn.NUM_GROUPS, eps)
    finite = bool(torch.isfinite(mean_c).all() and torch.isfinite(inv_c).all())
    negative = int((gn.group_moments(sums, shape[1])[1] < 0).sum())
    return {"ok": finite and negative > 0, "finite": finite, "negative_groups": negative}


def stats_summary(res) -> str:
    """One line of a gn_stats_check result."""
    return (f"sums rel {res['sums_rel']:.2e}, mean {res['mean_err']:.2e}, inv rel "
            f"{res['inv_rel']:.2e}, GN+SiLU {res['apply_err']:.2e}, two calls "
            f"{'bit-identical' if res['same_bits'] else 'DIFFER'}: "
            f"{'ok' if res['ok'] else 'DISAGREES'}")


def gn_backward_agreement(got, want):
    """(dx, dscale, dbias) against the plain version's under the K2c
    tolerance (see the module note): {dx_err, affine_rel_err, ok, tolerance}."""
    ref = want[0].float().abs()
    diff = (got[0].float() - want[0].float()).abs()
    if want[0].dtype == torch.float32:
        tol, ok = "dx 1e-4", bool((diff <= 1e-4).all())
    else:
        tol = "dx 2^-7 |dx| + 2^-12 max|dx|"
        ok = bool((diff <= 2 ** -7 * ref + 2 ** -12 * ref.max()).all())
    aff = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got[1:], want[1:]))
    return {"dx_err": float(diff.max()), "affine_rel_err": aff,
            "ok": ok and aff <= 1e-5, "tolerance": tol + "; dscale, dbias 1e-5 max|ref|"}


def wrapper_route(shape, dtype, sms) -> str:
    """What the K2c wrapper does with a call: the design it picks, or the
    number of channel chunks it cuts the call into."""
    chunks = gn.bwd_channel_chunks(shape[2], gn.NUM_GROUPS, dtype.itemsize)
    if chunks > 1:
        return f"{chunks} channel chunks"
    return gn.bwd_design(*shape, dtype.itemsize, sms)


def gn_backward_check(x, g, mean_c, inv_c, scale, bias, design=None):
    """K2c (the wrapper, or the design named, called directly) against
    groupnorm_silu_backward_plain, and a second call against the first:
    {dx_err, affine_rel_err, ok, tolerance, same_bits}. `ok` needs both the
    tolerance and the same bits (both designs add in a fixed order and use
    no float atomics)."""
    fn = gn.groupnorm_silu_backward if design is None else GN_BWD_DESIGNS[design]
    got = fn(x, g, mean_c, inv_c, scale, bias)
    again = fn(x, g, mean_c, inv_c, scale, bias)
    res = gn_backward_agreement(got, gn.groupnorm_silu_backward_plain(
        x, g, mean_c, inv_c, scale, bias))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return {**res, "same_bits": same, "ok": res["ok"] and same}


def main() -> int:
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for src, lines in build_reports().items():
        for line in lines:
            print(f"[{src}] {line}")
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = []
    for shape in ATTN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            res = attention_check(*qkv_inputs(shape, dt, gen, dev))
            design = f" ({attn.bf16_design(shape[1])})" if dt == torch.bfloat16 else ""
            print(f"K1 {shape} {dt}{design}: {attention_summary(res)}")
            bad += [] if res["ok"] else [("K1", shape, dt)]
    for shape in dict.fromkeys([*FLAGSHIP_GN_SITES, *GN_SHAPES]):
        for dt in (torch.bfloat16, torch.float32):
            for form in AFFINE_FORMS:
                inputs = gn_inputs(shape, dt, form, gen, dev)
                for design in GN_BWD_DESIGNS:
                    res = gn_backward_check(*inputs, design=design)
                    print(f"K2c {design} {shape} {dt} {form}: max|dx| diff "
                          f"{res['dx_err']:.3e}, affine rel {res['affine_rel_err']:.2e} "
                          f"({res['tolerance']}), two calls "
                          f"{'bit-identical' if res['same_bits'] else 'DIFFER'}: "
                          f"{'ok' if res['ok'] else 'DISAGREES'}")
                    bad += [] if res["ok"] else [("K2c", design, shape, dt, form)]
    for shape, eps in STATS_CASES:
        for dt in (torch.bfloat16, torch.float32):
            x = (1.5 * torch.randn(shape, generator=gen, device=dev) + 0.3).to(dt)
            res = gn_stats_check(x, gn.NUM_GROUPS, eps, gen)
            print(f"K2a {shape} {dt} eps {eps:g}: {stats_summary(res)}")
            bad += [] if res["ok"] else [("K2a", shape, dt, eps)]
    for dt in (torch.bfloat16, torch.float32):
        res = gn_clip_check(dt, dev)
        print(f"K2a clip case (8, 4096, 512) {dt} eps 1e-6: mean_c, inv_c finite "
              f"{res['finite']}, {res['negative_groups']} groups below 0 before the clip: "
              f"{'ok' if res['ok'] else 'FAILS'}")
        bad += [] if res["ok"] else [("K2a clip", dt)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in BATCH1_ATTN_SHAPES:
        res = attention_check(*qkv_inputs(shape, torch.float32, gen, dev))
        print(f"K1 {shape} torch.float32: {attention_summary(res)}")
        bad += [] if res["ok"] else [("K1", shape, torch.float32)]
    cases = [(part, eps, shape, dt) for part, (eps, sites) in LATENT_GN_SITES.items()
             for shape in sites for dt in (torch.bfloat16, torch.float32)]
    cases += [(f"{part} batch 1", eps, shape, torch.float32)
              for part, (eps, sites) in BATCH1_GN_SITES.items() for shape in sites]
    cases += [("ddpm", DDPM_EPS, shape, dt) for shape in DDPM_GN_SITES
              for dt in (torch.bfloat16, torch.float32)]
    for part, eps, shape, dt in cases:
        designs = gn.bwd_designs(*shape, dt.itemsize, sms)
        for form in AFFINE_FORMS:
            inputs = gn_inputs(shape, dt, form, gen, dev, eps)
            for design in (*designs, None):
                res = gn_backward_check(*inputs, design=design)
                name = design or f"wrapper ({wrapper_route(shape, dt, sms)})"
                print(f"K2c {part} {name} {shape} {dt} {form} "
                      f"eps {eps:g}: max|dx| diff {res['dx_err']:.3e}, affine rel "
                      f"{res['affine_rel_err']:.2e}, two calls "
                      f"{'bit-identical' if res['same_bits'] else 'DIFFER'}: "
                      f"{'ok' if res['ok'] else 'DISAGREES'}")
                bad += [] if res["ok"] else [("K2c", part, design, shape, dt, form)]
    print(card(dev))
    print(f"{'all cases agree' if not bad else f'{len(bad)} cases disagree: {bad}'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
