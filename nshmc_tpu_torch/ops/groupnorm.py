"""Fused GroupNorm + affine + SiLU on channels-last activations (kernel K2).

Port of `nshmc_tpu/ops/groupnorm.py`, which splits the function into two
Pallas TPU kernels: `_stats_kernel` (:55, per-channel [sum x, sum x^2] in
fp32, accumulated across row blocks in grid order) and `_norm_kernel` (:75,
(x - mean) * inv * scale + bias, then SiLU, cast to the input dtype), with
an O(B*C) group combine in XLA between them. The JAX U-Net computes the same
function in XLA (`ChanStatsGroupNorm` + silu); this port routes every
GroupNorm->SiLU site of the U-Net through these kernels, including the
scale-shift `out_norm` sites: the affine is per (batch, channel), so
scale = gamma * (1 + s) and bias = beta * (1 + s) + shift cover
`GN -> h * (1 + s) + shift -> SiLU` with the same kernel.

Hopper translation (launched only for CUDA tensors). Both halves are
bound by bytes and do no tensor-core work:
  - K2a and the group combine, `group_stats`: ONE launch of the CUDA kernel
    csrc/groupnorm_stats.cu reads x once and writes the per-channel
    [sum x, sum x^2] and the channel-expanded mean and rsqrt(var + eps)
    (var = max(E[x^2] - E[x]^2, 0); eps 1e-5 in the U-Nets, 1e-6 in the VQ
    autoencoder). Blocks run in parallel in no order, so the TPU's
    sequential accumulation across grid steps becomes slab partials that
    the last CTA of each batch element adds in slab order (no float
    atomics: the same bits on every run); `stats_plan` cuts the call. See
    the source's header for the design.
  - K2b, `normalize_silu`: a Triton kernel streams x once more and writes
    y; each program loads 2-D (rows, 128-channel) tiles, so loads are
    coalesced (268 MB at (8, 256*256, 128) bf16, ~80 us at 3.35 TB/s).

`group_stats` (and `channel_stats`, its sums alone, sharing its launch
count) and `normalize_silu` are the wrappers: CUDA tensor -> the kernel
(counted in `.launches`), CPU tensor -> the plain version, anything else
raises. `groupnorm_silu` is the `torch.autograd.Function`.
Its forward saves x and the (B, C) fp32 statistics K2a produced; its
backward is the closed-form gradient of the function (the one `_gn_bwd`,
nshmc_tpu/ops/groupnorm.py:150, gets by differentiating
`groupnorm_silu_xla`): `groupnorm_silu_backward`, the wrapper of the CUDA
kernel K2c (`csrc/groupnorm_bwd.cu`, see its header for what bounds it):
`bwd_design` picks, by the call's shape, its one-launch design, which reads
x and g once (`bwd_plan` cuts the call), or its two-pass design, whichever
the card runs faster there; `groupnorm_silu_backward_plain` for CPU tensors. No statistics
are recomputed and no autograd graph is built.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os

import torch

from . import _build

NUM_GROUPS = 32
EPS = 1e-5
_TILE = 8192        # elements per program tile of the apply kernel


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton apply kernel K2b at first launch (no triton on CPU hosts).
    Triton's compile cache goes beside the CUDA builds unless the caller
    chose another place."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_build.BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def apply_kernel(x_ptr, y_ptr, mean_ptr, inv_ptr, scale_ptr, bias_ptr,
                     R, C, affine_sb,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        rb = tl.program_id(0)
        cb = tl.program_id(1)
        b = tl.program_id(2).to(tl.int64)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        rows = rb * BLOCK_R + tl.arange(0, BLOCK_R)
        mask = (rows < R)[:, None] & cmask[None, :]
        mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
        inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
        scale = tl.load(scale_ptr + b * affine_sb + cols, mask=cmask, other=0.0)
        bias = tl.load(bias_ptr + b * affine_sb + cols, mask=cmask, other=0.0)
        offs = b * R * C + rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * inv[None, :]
        y = y * scale[None, :] + bias[None, :]
        y = y * tl.sigmoid(y)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, apply_kernel


def _blocks(c: int):
    block_c = min(128, _next_pow2(c))
    return block_c, max(1, _TILE // block_c)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _check_cuda(x: torch.Tensor, what: str):
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: expects a contiguous (B, rows, C) tensor, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype}")


# --------------------------------------------------------------------------
# stats: (B, R, C) -> (B, 2, C) fp32 [sum x, sum x^2] per channel (K2a) and the
# group combine's channel-expanded (mean, rsqrt(var + eps)), in one launch of
# csrc/groupnorm_stats.cu

STATS_THREADS = 256     # csrc/groupnorm_stats.cu THREADS: a CTA's threads
STATS_MAX_C = 2048      # csrc/groupnorm_stats.cu MAX_C
STATS_MAX_G = 256       # csrc/groupnorm_stats.cu MAX_G
STATS_UNROLL = 8        # csrc/groupnorm_stats.cu UNROLL: 16-byte loads a thread keeps in flight
# the CTAs an SM the slabs aim at (scripts/groupnorm_stats_variants.py times 4
# beside it on the card: 2 is faster at most sites, where fewer slabs shorten
# the last CTA's finish and the kernel's two blocks an SM run in one wave)
STATS_CTAS_PER_SM = 2


def channel_stats_plain(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def group_moments(stats: torch.Tensor, rows: int, num_groups: int = NUM_GROUPS):
    """(B, 2, C) channel sums -> (mean, E[x^2] - mean^2) per group, each
    (B, groups) fp32, the variance before the clip."""
    b, _, c = stats.shape
    cg = c // num_groups
    n = rows * cg
    mean = stats[:, 0].reshape(b, num_groups, cg).sum(-1) / n
    return mean, stats[:, 1].reshape(b, num_groups, cg).sum(-1) / n - mean**2


def group_combine(stats: torch.Tensor, rows: int, num_groups: int = NUM_GROUPS,
                  eps: float = EPS):
    """(B, 2, C) channel sums -> channel-expanded (mean, rsqrt(var + eps)),
    each (B, C) fp32, with var = max(E[x^2] - E[x]^2, 0) over each group
    (nshmc_tpu/ops/groupnorm.py:104-112). The clip is flax `nn.GroupNorm`'s
    (the VQ autoencoder's norms): a group with a large mean and a small
    spread can round E[x^2] - E[x]^2 below 0, where rsqrt(var + eps) would
    be NaN at eps 1e-6."""
    cg = stats.shape[2] // num_groups
    mean, var = group_moments(stats, rows, num_groups)
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return (mean.repeat_interleave(cg, dim=1).contiguous(),
            inv.repeat_interleave(cg, dim=1).contiguous())


def group_stats_plain(x: torch.Tensor, num_groups: int = NUM_GROUPS, eps: float = EPS):
    """K2a's plain version: (sums (B, 2, C), mean_c, inv_c (B, C)), fp32."""
    sums = channel_stats_plain(x)
    return (sums, *group_combine(sums, x.shape[1], num_groups, eps))


@dataclasses.dataclass(frozen=True)
class StatsPlan:
    """How csrc/groupnorm_stats.cu cuts a (B, R, C) call: a row of C / VEC
    16-byte vectors into `n_cb` channel blocks of `cbv` vectors (the last
    may be narrower), whose CTA reads `rows_per_pass` rows at a time; the R
    rows into `slabs` slabs, slab s holding rows s R / slabs to (s + 1) R /
    slabs. Grid (slabs, n_cb, B): `ctas` CTAs, of which the last of each
    batch element to finish adds that element's slabs in slab order."""
    cbv: int
    n_cb: int
    rows_per_pass: int
    slabs: int
    ctas: int

    def slab_rows(self, r: int, s: int) -> range:
        """The rows of slab s."""
        return range(s * r // self.slabs, (s + 1) * r // self.slabs)


@functools.lru_cache(maxsize=None)
def stats_plan(b: int, r: int, c: int, elem_size: int, sms: int,
               ctas_per_sm: int = STATS_CTAS_PER_SM) -> StatsPlan:
    """The plan of K2a for x: (b, r, c) of `elem_size` bytes on a card with
    `sms` SMs: channel blocks of at most 256 vectors, as even as they come;
    then as many slabs as give `ctas_per_sm` CTAs an SM, every SM the same
    number, but no slab shorter than one unrolled pass (STATS_UNROLL loads
    of `rows_per_pass` rows)."""
    cv = c // (16 // elem_size)
    n_cb = _cdiv(cv, STATS_THREADS)
    cbv = _cdiv(cv, n_cb)
    rpi = STATS_THREADS // cbv
    want = _cdiv(ctas_per_sm * sms, b * n_cb)  # slabs wanted per (batch, channel block)
    slabs = max(1, min(want, r // (rpi * STATS_UNROLL)))
    return StatsPlan(cbv=cbv, n_cb=n_cb, rows_per_pass=rpi, slabs=slabs, ctas=b * n_cb * slabs)


def declare_stats(fn):
    """`nshmc_gn_stats` of a loaded library, its C signature declared."""
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _stats_launcher():
    """The C launcher of csrc/groupnorm_stats.cu, built and loaded at first use."""
    return declare_stats(_build.load("groupnorm_stats.cu").nshmc_gn_stats)


_stats_counter_bufs: dict = {}


def _stats_counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's int32 arrival counters for K2a, one a batch element:
    zeroed once, left zero by every launch; grown (a new zeroed buffer) only
    when a call needs more. Apart from K2c's (`_bwd_counters`)."""
    buf = _stats_counter_bufs.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _stats_counter_bufs[device] = buf
    return buf


def launch_stats(x: torch.Tensor, plan: StatsPlan, num_groups: int = NUM_GROUPS,
                 eps: float = EPS, launcher=None):
    """One launch of csrc/groupnorm_stats.cu (or of `launcher`, a declared
    copy of its C launcher) on `plan`, for x the wrapper has checked;
    counts no launch. Returns (sums, mean_c, inv_c)."""
    b, r, c = x.shape
    part = torch.empty((b, plan.slabs, 2, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    mean_c = torch.empty((b, c), dtype=torch.float32, device=x.device)
    inv_c = torch.empty((b, c), dtype=torch.float32, device=x.device)
    counters = _stats_counters(x.device, b)
    with torch.cuda.device(x.device):
        rc = (launcher or _stats_launcher())(
            x.data_ptr(), part.data_ptr(), sums.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
            counters.data_ptr(), 1 if x.dtype == torch.bfloat16 else 0, b, r, c, num_groups,
            eps, plan.cbv, plan.n_cb, plan.slabs, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "nshmc_gn_stats")
    return sums, mean_c, inv_c


class _K2aWrapper:
    """K2a's two wrappers, `group_stats` and `channel_stats`, count the same
    launches: reading or setting `.launches` on either reads or sets one
    number."""
    _count = 0

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._fn = fn

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    @property
    def launches(self) -> int:
        return _K2aWrapper._count

    @launches.setter
    def launches(self, value: int):
        _K2aWrapper._count = value


@_K2aWrapper
def group_stats(x: torch.Tensor, num_groups: int = NUM_GROUPS, eps: float = EPS):
    """K2a with the group combine: x (B, R, C) -> (sums (B, 2, C), mean_c,
    inv_c (B, C)), all fp32. A CUDA tensor launches csrc/groupnorm_stats.cu
    (counted once a call in `.launches`), a CPU tensor takes
    `group_stats_plain`, anything else raises. A C above the kernel's
    STATS_MAX_C (Stable Diffusion's 2560-channel U-Net decoder inputs) is
    cut into the fewest channel chunks of whole groups that fit
    (`stats_channel_chunks`), each copied out and launched on its own
    (`by_channel_chunks`): a device trace sees that many kernels, while
    `.launches` still counts the one call, as benchmark/sites.py predicts
    K2a's count from the GroupNorm calls. Calls on one device share its
    arrival counters, so they must not run concurrently on two streams."""
    if x.device.type == "cpu":
        return group_stats_plain(x, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_stats: unsupported device {x.device}")
    _check_cuda(x, "group_stats")
    b, r, c = x.shape
    n = stats_channel_chunks(c, num_groups)
    if r * (c // num_groups) >= 1 << 24:
        raise ValueError(f"group_stats: {r} rows x {c // num_groups} channels a group is not "
                         f"an exact fp32 count")
    if x.data_ptr() % 16:
        raise ValueError("group_stats: x must be 16-byte aligned")
    plan = stats_plan(b, r, c // n, x.element_size(), _sm_count(x.device.index or 0))
    out = by_channel_chunks(x, n, num_groups,
                            lambda xc, groups: launch_stats(xc, plan, groups, eps))
    group_stats.launches += 1
    return out


def by_channel_chunks(x: torch.Tensor, n: int, num_groups: int, stats):
    """stats(x, num_groups) over n channel chunks of whole groups of x (B,
    R, C), each copied out and given its own groups, joined along C."""
    if n == 1:
        return stats(x, num_groups)
    parts = [stats(xc.contiguous(), num_groups // n) for xc in x.split(x.shape[2] // n, dim=2)]
    return tuple(torch.cat(t, dim=-1) for t in zip(*parts))


def stats_channel_chunks(c: int, num_groups: int) -> int:
    """Into how many channel chunks of whole groups K2a cuts a call: the
    fewest (dividing the group count) of at most STATS_MAX_C channels, each
    a multiple of 8."""
    if c % 8 or c % num_groups or num_groups > STATS_MAX_G:
        raise ValueError(f"group_stats: C = {c} must be a multiple of 8 and of {num_groups} "
                         f"groups, with at most {STATS_MAX_G} groups")
    for n in range(1, num_groups + 1):
        if num_groups % n == 0 and c // n <= STATS_MAX_C and (c // n) % 8 == 0:
            return n
    raise ValueError(f"group_stats: no chunks of whole groups of C = {c} ({num_groups} groups) "
                     f"fit {STATS_MAX_C} channels")


@_K2aWrapper
def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """K2a's per-channel sums (B, 2, C) fp32: on the card, the sums of
    `group_stats`' launch (its count); on the CPU, the plain version."""
    if x.device.type == "cpu":
        return channel_stats_plain(x)
    return group_stats(x)[0]


# --------------------------------------------------------------------------
# apply: SiLU((x - mean) * inv * scale + bias) in x's dtype (K2b)


def normalize_silu_plain(x, mean_c, inv_c, scale, bias):
    """x: (B, R, C); mean_c, inv_c: (B, C); scale, bias: (C,) or (B, C)."""
    scale = scale.reshape(-1, 1, x.shape[-1]) if scale.dim() == 2 else scale
    bias = bias.reshape(-1, 1, x.shape[-1]) if bias.dim() == 2 else bias
    y = (x.float() - mean_c[:, None]) * inv_c[:, None]
    y = y * scale + bias
    return (y * torch.sigmoid(y)).to(x.dtype)


def normalize_silu(x, mean_c, inv_c, scale, bias):
    if x.device.type == "cpu":
        return normalize_silu_plain(x, mean_c, inv_c, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"normalize_silu: unsupported device {x.device}")
    _check_cuda(x, "normalize_silu")
    b, r, c = x.shape
    if scale.shape != bias.shape or scale.shape not in ((c,), (b, c)):
        raise ValueError(f"normalize_silu: affine {tuple(scale.shape)} for {tuple(x.shape)}")
    for t in (mean_c, inv_c):
        if t.shape != (b, c) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"normalize_silu: statistics {tuple(t.shape)} {t.dtype} "
                             f"on {t.device} for {tuple(x.shape)} on {x.device}")
    mean_c, inv_c = mean_c.contiguous(), inv_c.contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    triton, apply_kernel = _kernels()
    block_c, block_r = _blocks(c)
    y = torch.empty_like(x)
    grid = (triton.cdiv(r, block_r), triton.cdiv(c, block_c), b)
    with torch.cuda.device(x.device):
        apply_kernel[grid](x, y, mean_c, inv_c, scale, bias, r, c,
                           c if scale.dim() == 2 else 0,
                           BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8)
    normalize_silu.launches += 1
    return y


normalize_silu.launches = 0


# --------------------------------------------------------------------------
# the whole function


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


def groupnorm_silu_plain(x, scale, bias, num_groups: int = NUM_GROUPS,
                         eps: float = EPS):
    """Plain PyTorch GN(fp32 stats) -> affine -> SiLU -> x.dtype.
    x: (B, *spatial, C) channels-last; scale, bias: (C,) or (B, C)."""
    x3 = _as_rows(x)
    mean_c, inv_c = group_combine(channel_stats_plain(x3), x3.shape[1],
                                  num_groups, eps)
    return normalize_silu_plain(x3, mean_c, inv_c, scale, bias).reshape(x.shape)


# --------------------------------------------------------------------------
# backward: (dx, dscale, dbias) from x, the cotangent and the forward's
# statistics (K2c)

_BWD_THREADS = 256     # csrc/groupnorm_bwd.cu: one block covers 256 / (C / VEC) rows
_BWD_SLAB_ROWS = 1024  # the two-pass design: most rows of one batch element per block
_BWD_FINISH_SMEM = 48 * 1024  # the two-pass design's finish kernel: 8 * B * C / groups bytes
# Hopper's shared memory (the H100's 132 SMs): 228 KB an SM, 227 KB a block,
# 1 KB of each SM's kept back for every resident block
SMEM_SM = 233472
SMEM_CTA = 232448
_SMEM_RESERVED = 1024
_BWD_MAX_V = 512       # csrc/groupnorm_bwd.cu F_MAX_V: 4 * CK values a unit
_BWD_BOX_MAX = 256     # a TMA box has at most 256 rows
_BWD_MAX_BOX = 8       # csrc/groupnorm_bwd.cu F_MAX_BOX: boxes (and mbarriers) a slab
_BWD_BUFS = 2          # csrc/groupnorm_bwd.cu F_BUFS: slab buffers a CTA
_BWD_MAX_CK = _BWD_MAX_V // 4  # csrc/groupnorm_bwd.cu F_MAX_CK: channels a unit
_BWD_SMALL_V = 256     # csrc/groupnorm_bwd.cu F_SMALL_V: values of red3 and of kk
_BWD_MIN_ROW_BYTES = 64  # the narrowest row piece of a unit
_BWD_BOX_PIPE = 128    # rows a box aims at (at least one row step of the block)
_BWD_ALIGN = 128       # TMA box destinations are 128-byte aligned
_BWD_SMALL_UNIT = 64 * 1024
# The one launch is the faster design where its plan cuts a unit into at most
# this many slabs (so at most this many CTAs meet at each handoff), the
# two-pass design where it takes more (both timed on an H100 at the
# flagship's 18 shapes in bf16 and f32 by scripts/groupnorm_bwd_variants.py;
# PERF.md section 6)
BWD_ONE_LAUNCH_MAX_SLABS = 16


@functools.lru_cache(maxsize=None)
def _bwd_launchers():
    """The C launchers of csrc/groupnorm_bwd.cu's two designs, built and
    loaded at first use."""
    lib = _build.load("groupnorm_bwd.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    one, two = lib.nshmc_gn_bwd, lib.nshmc_gn_bwd_twopass
    one.restype = two.restype = i32
    one.argtypes = [ptr] * 6 + [i32] + [ptr] * 5 + [i32] * 11 + [ptr]
    two.argtypes = [ptr] * 6 + [i32] + [ptr] * 5 + [i32] * 6 + [ptr]
    return one, two


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How csrc/groupnorm_bwd.cu's one launch cuts a (B, R, C) call: units
    of (batch element, `ck` channels), each cut into `slabs` row slabs of
    `n_box` TMA boxes of `box_rows` rows; CTA i takes slab i % slabs of
    units i // slabs, + units_in_flight, ... The grid is units_in_flight *
    slabs CTAs, at most ctas_per_sm on each SM, each with `smem` bytes of
    dynamic shared memory (two buffers of its slab of x and of da)."""
    ck: int
    slabs: int
    units_in_flight: int
    box_rows: int
    n_box: int
    ctas_per_sm: int
    smem: int
    units: int
    scratch_floats: int
    counters: int

    @property
    def slab_rows(self) -> int:
        return self.box_rows * self.n_box

    @property
    def grid(self) -> int:
        return self.units_in_flight * self.slabs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_smem(vec: int, elem_size: int, slab_elems: int) -> int:
    """csrc/groupnorm_bwd.cu `fused_smem` for slabs of `slab_elems`
    elements: alignment slack, two buffers of a slab of x and of g, the
    slab's da in fp32, the block reduction's rows, three value arrays, two
    sets of a unit's per-channel constants, and an mbarrier for each box of
    x and of g of each buffer."""
    return (_BWD_ALIGN + _BWD_BUFS * 2 * slab_elems * elem_size + slab_elems * 4
            + _BWD_THREADS * vec * 4 + (_BWD_MAX_V + 2 * _BWD_SMALL_V) * 4 + _BWD_BUFS * 4 * _BWD_MAX_CK * 4
            + _BWD_BUFS * 2 * _BWD_MAX_BOX * 8)


@functools.lru_cache(maxsize=None)
def bwd_plan(b: int, r: int, c: int, elem_size: int, sms: int,
             num_groups: int = NUM_GROUPS) -> BwdPlan:
    """The plan of the one-launch K2c for x: (b, r, c) of `elem_size` bytes
    on a card with `sms` SMs. CK, the unit's channels: the narrowest
    multiple of the group size and of the 16-byte vector that divides C
    with at least 64 bytes a row (more, smaller units). Then 2 CTAs an SM
    (1 where a slab does not fit in half an SM): the fewest slabs a unit
    whose two slab buffers of x and g, and its da in fp32, fit, then as
    many units in flight as the card holds; slabs raised until the units in
    flight fill the grid, but no slab shorter than one row step of the
    block, and one slab (no handoff) for a unit of x and g of 64 KB or less.
    Boxes of ~128 rows, at least one row step."""
    vec = 16 // elem_size
    cg = c // num_groups
    step = math.lcm(cg, vec)
    cands = [ck for ck in range(step, min(c, _BWD_MAX_V // 4) + 1, step)
             if c % ck == 0 and ck * elem_size >= _BWD_MIN_ROW_BYTES]
    if not cands:
        raise ValueError(f"bwd_plan: no channel chunk for C = {c}, {num_groups} groups, "
                         f"{elem_size}-byte elements")
    ck = cands[0]
    ng = ck // cg
    row_bytes = ck * elem_size
    align_rows = _BWD_ALIGN // math.gcd(_BWD_ALIGN, row_bytes)
    fixed = bwd_smem(vec, elem_size, 0)
    units = b * (c // ck)
    # no slab shorter than a row step; a unit of <= 64 KB stays whole (its
    # load takes less time than a handoff between CTAs)
    row_step = _BWD_THREADS // (ck // vec)
    s_cap = 1 if 2 * r * row_bytes <= _BWD_SMALL_UNIT else max(1, _cdiv(r, row_step))
    for cps in (2, 1):
        budget = min(SMEM_CTA, SMEM_SM // cps - _SMEM_RESERVED)
        rows_max = ((budget - fixed) // (ck * (_BWD_BUFS * 2 * elem_size + 4))
                    // align_rows * align_rows)
        if rows_max < align_rows or _cdiv(r, rows_max) > sms * cps:
            continue
        ctas = sms * cps
        s = max(_cdiv(r, rows_max), min(ctas // units, s_cap))
        q = max(1, min(units, ctas // s))
        s = max(s, min(ctas // q, s_cap))
        while True:  # slabs of whole boxes of <= 256 rows, each 128-byte aligned
            n_box = max(_cdiv(_cdiv(r, s), _BWD_BOX_MAX),
                        min(_BWD_MAX_BOX, _cdiv(_cdiv(r, s), max(_BWD_BOX_PIPE, row_step))))
            box_rows = _cdiv(_cdiv(_cdiv(r, s), n_box), align_rows) * align_rows
            smem = bwd_smem(vec, elem_size, n_box * box_rows * ck)
            if smem <= budget:
                break
            s += 1
        slabs = _cdiv(r, n_box * box_rows)
        q = min(q, ctas // slabs)
        if q < 1:
            continue
        scratch = units * slabs * (2 * ck + 2 * ng) + 2 * b * c
        return BwdPlan(ck=ck, slabs=slabs, units_in_flight=q, box_rows=box_rows, n_box=n_box,
                       ctas_per_sm=cps, smem=smem, units=units, scratch_floats=scratch,
                       counters=2 * units + 2)
    raise ValueError(f"bwd_plan: ({b}, {r}, {c}) with {elem_size}-byte elements does not fit "
                     f"{sms} SMs")


@functools.lru_cache(maxsize=None)
def bwd_design(b: int, r: int, c: int, elem_size: int, sms: int,
               num_groups: int = NUM_GROUPS) -> str:
    """Which of csrc/groupnorm_bwd.cu's designs K2c launches for x: (b, r,
    c) on a card with `sms` SMs: "one_launch" where `bwd_plan` cuts a unit
    into at most BWD_ONE_LAUNCH_MAX_SLABS slabs, else "twopass"; but
    "one_launch" wherever the two-pass finish kernel's shared memory cannot
    hold the batch's group sums, and "twopass" wherever the one launch has
    no plan."""
    if 8 * b * (c // num_groups) > _BWD_FINISH_SMEM:
        return "one_launch"
    try:
        slabs = bwd_plan(b, r, c, elem_size, sms, num_groups).slabs
    except ValueError:
        return "twopass"
    return "one_launch" if slabs <= BWD_ONE_LAUNCH_MAX_SLABS else "twopass"


def bwd_designs(b: int, r: int, c: int, elem_size: int, sms: int,
                num_groups: int = NUM_GROUPS) -> tuple:
    """The designs that can take x: (b, r, c) in one kernel call, whichever
    `bwd_design` picks: none where the wrapper cuts the call into channel
    chunks, "one_launch" where `bwd_plan` has a plan, "twopass" where its
    finish kernel's shared memory holds the batch's group sums."""
    if bwd_channel_chunks(c, num_groups, elem_size) > 1:
        return ()
    out = []
    try:
        bwd_plan(b, r, c, elem_size, sms, num_groups)
        out.append("one_launch")
    except ValueError:
        pass
    if 8 * b * (c // num_groups) <= _BWD_FINISH_SMEM:
        out.append("twopass")
    return tuple(out)


_bwd_counter_bufs: dict = {}


def _bwd_counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's int32 handoff counters for the one-launch K2c: zeroed
    once, left zero by every launch; grown (a new zeroed buffer) only when a
    call needs more."""
    buf = _bwd_counter_bufs.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _bwd_counter_bufs[device] = buf
    return buf


def counter_buffers(device: torch.device) -> tuple:
    """K2a's and K2c's counter buffers on `device` as they are now (None
    where none is made yet). A CUDA graph that captured a launch holds
    them: a buffer grown later replaces the dict's entry, not the graph's
    pointer."""
    return _stats_counter_bufs.get(device), _bwd_counter_bufs.get(device)


def bwd_slab_rows(b: int, r: int, c: int, elem_size: int, sms: int) -> int:
    """The two-pass design's rows per partial-sums block: 1,024, halved
    while the (slab, batch) grid would give the SMs fewer than two blocks
    each, down to four row steps of a block."""
    rows_per_step = _BWD_THREADS // (c // (16 // elem_size))
    rows = _BWD_SLAB_ROWS
    while rows > 4 * rows_per_step and b * -(-r // rows) < 2 * sms:
        rows //= 2
    return rows


def groupnorm_silu_backward_plain(x, g, mean_c, inv_c, scale, bias,
                                  num_groups: int = NUM_GROUPS):
    """The closed-form gradient of SiLU((x - mean) * inv * scale + bias)
    with GroupNorm statistics, all in fp32. x, g: (B, R, C); mean_c, inv_c:
    (B, C) fp32; scale, bias: (C,) or (B, C). Returns dx in x's dtype and
    dscale, dbias in fp32 of the affine's shape."""
    b, r, c = x.shape
    sc = scale.float().reshape(-1, 1, c)
    bi = bias.float().reshape(-1, 1, c)
    xhat = (x.float() - mean_c[:, None]) * inv_c[:, None]
    a = xhat * sc + bi
    s = torch.sigmoid(a)
    da = g.float() * s * (1 + a * (1 - s))
    dbias = da.sum(dim=1)             # (B, C)
    dscale = (da * xhat).sum(dim=1)
    cg = c // num_groups
    n = r * cg
    gamma = sc[:, 0].expand(b, c)
    k1 = (gamma * dbias).reshape(b, num_groups, cg).sum(-1) / n
    k2 = (gamma * dscale).reshape(b, num_groups, cg).sum(-1) / n
    k1 = k1.repeat_interleave(cg, dim=1)[:, None]
    k2 = k2.repeat_interleave(cg, dim=1)[:, None]
    dx = (inv_c[:, None] * (sc * da - (k1 + xhat * k2))).to(x.dtype)
    if scale.dim() == 1:
        dscale, dbias = dscale.sum(0), dbias.sum(0)
    return dx, dscale, dbias


def bwd_channel_chunks(c: int, num_groups: int, elem_size: int) -> int:
    """Into how many channel chunks of whole groups K2c cuts a call: 1 where
    a row's 16-byte vectors fit the block's 256 threads (C <= 2048 in bf16,
    1024 in f32), else the fewest chunks (dividing the group count) that do,
    each a multiple of 8 channels (the latent U-Net's 1120-1792-channel
    decoder inputs in f32)."""
    limit = _BWD_THREADS * (16 // elem_size)
    for n in range(1, num_groups + 1):
        if num_groups % n == 0 and c % n == 0 and c // n <= limit and (c // n) % 8 == 0:
            return n
    raise ValueError(f"groupnorm_silu_backward: no chunks of whole groups of C = {c} "
                     f"({num_groups} groups) fit {limit} channels")


def groupnorm_silu_backward(x, g, mean_c, inv_c, scale, bias,
                            num_groups: int = NUM_GROUPS):
    """K2c: CUDA tensors launch one of csrc/groupnorm_bwd.cu's two designs,
    the one `bwd_design` picks for the shape (`launch_one` or
    `launch_twopass`; `.launches` counts the kernel calls), CPU tensors take
    the plain version, anything else raises. A C too wide for the kernels'
    row layout is cut into channel chunks of whole groups
    (`bwd_channel_chunks`), one kernel call each. Calls on one device share
    its handoff counters, so they must not run concurrently on two
    streams."""
    if x.device.type == "cpu":
        return groupnorm_silu_backward_plain(x, g, mean_c, inv_c, scale, bias, num_groups)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu_backward: unsupported device {x.device}")
    _check_cuda(x, "groupnorm_silu_backward")
    b, r, c = x.shape
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError(f"groupnorm_silu_backward: cotangent {tuple(g.shape)} {g.dtype} "
                         f"on {g.device} for {tuple(x.shape)} {x.dtype} on {x.device}")
    if c % 8 or c % num_groups:
        raise ValueError(f"groupnorm_silu_backward: C = {c} must be a multiple of 8 and of "
                         f"{num_groups} groups")
    chunks = bwd_channel_chunks(c, num_groups, x.element_size())
    if scale.shape != bias.shape or scale.shape not in ((c,), (b, c)):
        raise ValueError(f"groupnorm_silu_backward: affine {tuple(scale.shape)} "
                         f"for {tuple(x.shape)}")
    for t in (mean_c, inv_c, scale, bias):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"groupnorm_silu_backward: statistics and affine must be fp32 "
                             f"on {x.device}, got {t.dtype} on {t.device}")
    if mean_c.shape != (b, c) or inv_c.shape != (b, c):
        raise ValueError(f"groupnorm_silu_backward: statistics {tuple(mean_c.shape)} "
                         f"{tuple(inv_c.shape)} for {tuple(x.shape)}")
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("groupnorm_silu_backward: x and g must be 16-byte aligned")
    if chunks > 1:  # whole groups a chunk: each is a GroupNorm of its own
        w = c // chunks
        parts = [groupnorm_silu_backward(
            *(t[..., i * w:(i + 1) * w].contiguous() for t in (x, g, mean_c, inv_c, scale, bias)),
            num_groups // chunks) for i in range(chunks)]
        return tuple(torch.cat(p, dim=-1) for p in zip(*parts))
    inputs = (x, g) + tuple(t.contiguous() for t in (mean_c, inv_c, scale, bias))
    sms = _sm_count(x.device.index or 0)
    if bwd_design(b, r, c, x.element_size(), sms, num_groups) == "twopass":
        out = launch_twopass(*inputs, num_groups)
    else:
        out = launch_one(*inputs, num_groups)
    groupnorm_silu_backward.launches += 1
    return out


groupnorm_silu_backward.launches = 0


def launch_one(x, g, mean_c, inv_c, scale, bias, num_groups: int = NUM_GROUPS):
    """One launch of the one-launch design `nshmc_gn_bwd` on `bwd_plan`'s
    plan, for inputs the wrapper has checked (contiguous, on one card);
    counted in `.launches`."""
    b, r, c = x.shape
    plan = bwd_plan(b, r, c, x.element_size(), _sm_count(x.device.index or 0), num_groups)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=x.device)
    counters = _bwd_counters(x.device, plan.counters)
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(bias)
    with torch.cuda.device(x.device):
        rc = _bwd_launchers()[0](
            x.data_ptr(), g.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), c if scale.dim() == 2 else 0,
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), scratch.data_ptr(),
            counters.data_ptr(), 1 if x.dtype == torch.bfloat16 else 0, b, r, c, num_groups,
            plan.ck, plan.slabs, plan.units_in_flight, plan.box_rows, plan.n_box, plan.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "nshmc_gn_bwd")
    launch_one.launches += 1
    return dx, dscale, dbias


launch_one.launches = 0


def launch_twopass(x, g, mean_c, inv_c, scale, bias, num_groups: int = NUM_GROUPS):
    """One call of the two-pass design `nshmc_gn_bwd_twopass` (three
    launches) for inputs the wrapper has checked; counted once in
    `.launches`. Raises where its finish kernel's shared memory cannot hold
    the batch's group sums."""
    b, r, c = x.shape
    if 8 * b * (c // num_groups) > _BWD_FINISH_SMEM:
        raise ValueError(f"launch_twopass: B * C / groups = {b * c // num_groups} exceeds "
                         f"the finish kernel's shared memory")
    rows = bwd_slab_rows(b, r, c, x.element_size(), _sm_count(x.device.index or 0))
    part = torch.empty((b, _cdiv(r, rows), 2, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(bias)
    with torch.cuda.device(x.device):
        rc = _bwd_launchers()[1](
            x.data_ptr(), g.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), c if scale.dim() == 2 else 0, part.data_ptr(), coef.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
            1 if x.dtype == torch.bfloat16 else 0, b, r, c, num_groups, rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "nshmc_gn_bwd_twopass")
    launch_twopass.launches += 1
    return dx, dscale, dbias


launch_twopass.launches = 0


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        x3 = _as_rows(x).contiguous()
        _, mean_c, inv_c = group_stats(x3, num_groups, eps)
        ctx.save_for_backward(x3, scale, bias, mean_c, inv_c)
        ctx.num_groups = num_groups
        return normalize_silu(x3, mean_c, inv_c, scale, bias).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x3, scale, bias, mean_c, inv_c = ctx.saved_tensors
        dx, dscale, dbias = groupnorm_silu_backward(
            x3, g.reshape(x3.shape).contiguous(), mean_c, inv_c, scale, bias, ctx.num_groups)
        need = ctx.needs_input_grad
        return (dx.reshape(g.shape) if need[0] else None, dscale if need[1] else None,
                dbias if need[2] else None, None, None)


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = NUM_GROUPS, eps: float = EPS) -> torch.Tensor:
    """Differentiable GN+affine+SiLU on channels-last x: (B, *spatial, C).
    scale, bias: fp32, (C,) or per (batch, channel) (B, C)."""
    return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps)
