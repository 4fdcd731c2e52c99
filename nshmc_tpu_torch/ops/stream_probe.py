"""Memory-system probe kernels P1-P4 (`csrc/stream_probe.cu`).

Port of the four Pallas TPU kernels of `scripts/pallas_stream_probe.py`,
which time the memory system at the GroupNorm hot shape (8, 65536, 128)
bf16. Each wrapper launches its CUDA kernel for a CUDA tensor (counted in
`.launches`), takes the plain PyTorch version for a CPU tensor, and raises
for any other device:

  - `probe_stats` (P1, `stats_kernel` :43): per-channel [sum x, sum x^2] in
    fp32, (B, R, C) -> (B, 2, C). Plain version: `groupnorm.channel_stats_plain`.
  - `probe_apply` (P2, `apply_kernel` :73): SiLU((x - mean) * inv * scale + bias)
    with (B, C) statistics and a (C,) affine, in x's dtype. Plain version:
    `groupnorm.normalize_silu_plain`. The group combine between P1 and P2
    (the probe's :81-87) is `groupnorm.group_combine`.
  - `probe_touch` (P3, `touch_kernel` :183): streams all of x through shared
    memory by TMA and returns x[:, R - RB] as (B, 1, C) fp32, the row the
    TPU grid's last block writes.
  - `probe_mma_stats` (P4, `mxu_stats_kernel` :198): the P1 function on tensor
    cores (`mma.sync` with a ones matrix). Plain version: `channel_stats_plain`.

Every kernel takes a contiguous bf16 (B, R, C) tensor with C a multiple of 8
(at most 2048); the wrappers check that on every device, so the CPU path
refuses what the card would.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .groupnorm import channel_stats_plain, normalize_silu_plain

RB = 2048  # rows per TPU block: the probe's (1, 2048, C) BlockSpec
MAX_CHANNELS = 2048  # csrc/stream_probe.cu: C / 8 threads cover one row of a 256-thread block


@functools.lru_cache(maxsize=None)
def _lib():
    """csrc/stream_probe.cu, built and loaded at first use."""
    return declare(_build.load("stream_probe.cu"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of every launcher of a
    library built from csrc/stream_probe.cu."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in (("nshmc_probe_slabs", [i32]),
                       ("nshmc_probe_stats", [ptr] * 3 + [i32] * 3 + [ptr]),
                       ("nshmc_probe_apply", [ptr] * 6 + [i32] * 3 + [ptr]),
                       ("nshmc_probe_touch", [ptr] * 2 + [i32] * 4 + [ptr]),
                       ("nshmc_probe_mma_stats", [ptr] * 3 + [i32] * 3 + [ptr])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib


def _route(x: torch.Tensor, what: str) -> bool:
    """Check x and say whether it goes to the kernel (True) or the plain
    version (False)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: dtype {x.dtype} (bfloat16 only)")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: expects a contiguous (B, R, C) tensor, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    if c % 8 or not 8 <= c <= MAX_CHANNELS:
        raise ValueError(f"{what}: C = {c} must be a multiple of 8 in [8, {MAX_CHANNELS}]")
    if x.device.type == "cpu":
        return False
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer not 16-byte aligned")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def stats_launch(x: torch.Tensor, launcher: str, lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """Run P1's or P4's launcher of `lib` (the built source by default) on a
    CUDA tensor; counts no launch."""
    b, r, c = x.shape
    lib = lib or _lib()
    part = torch.empty((b, lib.nshmc_probe_slabs(r), 2, c), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, launcher)(x.data_ptr(), part.data_ptr(), out.data_ptr(), b, r, c,
                                    _stream(x))
    _build.check(rc, launcher)
    return out


def probe_stats(x: torch.Tensor) -> torch.Tensor:
    """P1: (B, R, C) bf16 -> (B, 2, C) fp32 [sum x, sum x^2] per channel."""
    if not _route(x, "probe_stats"):
        return channel_stats_plain(x)
    out = stats_launch(x, "nshmc_probe_stats")
    probe_stats.launches += 1
    return out


probe_stats.launches = 0


def probe_apply(x: torch.Tensor, mean_c: torch.Tensor, inv_c: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """P2: SiLU((x - mean_c) * inv_c * scale + bias) in x's dtype; mean_c,
    inv_c: (B, C) fp32; scale, bias: (C,)."""
    if not _route(x, "probe_apply"):
        return normalize_silu_plain(x, mean_c, inv_c, scale, bias)
    b, r, c = x.shape
    for name, t, shape in (("mean_c", mean_c, (b, c)), ("inv_c", inv_c, (b, c)),
                           ("scale", scale, (c,)), ("bias", bias, (c,))):
        if t.shape != shape or t.device != x.device:
            raise ValueError(f"probe_apply: {name} {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {x.device}")
    mean_c, inv_c, scale, bias = (t.float().contiguous() for t in (mean_c, inv_c, scale, bias))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().nshmc_probe_apply(x.data_ptr(), y.data_ptr(), mean_c.data_ptr(),
                                      inv_c.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                      b, r, c, _stream(x))
    _build.check(rc, "nshmc_probe_apply")
    probe_apply.launches += 1
    return y


probe_apply.launches = 0


def touch_plain(x: torch.Tensor) -> torch.Tensor:
    """The row the TPU grid's last (1, RB, C) block writes: x[:, R - RB]."""
    return x[:, (x.shape[1] // RB - 1) * RB].float()[:, None]


def probe_touch(x: torch.Tensor) -> torch.Tensor:
    """P3: stream all of x (bf16 (B, R, C), R a multiple of RB) and return
    x[:, R - RB] as (B, 1, C) fp32."""
    on_card = _route(x, "probe_touch")
    b, r, c = x.shape
    if r % RB:
        raise ValueError(f"probe_touch: R = {r} is not a multiple of the block rows {RB} "
                         f"(the TPU grid is R // {RB})")
    if not on_card:
        return touch_plain(x)
    out = torch.empty((b, 1, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().nshmc_probe_touch(x.data_ptr(), out.data_ptr(), b, r, c, RB, _stream(x))
    _build.check(rc, "nshmc_probe_touch")
    probe_touch.launches += 1
    return out


probe_touch.launches = 0


def probe_mma_stats(x: torch.Tensor) -> torch.Tensor:
    """P4: the P1 function, computed on tensor cores."""
    if not _route(x, "probe_mma_stats"):
        return channel_stats_plain(x)
    out = stats_launch(x, "nshmc_probe_mma_stats")
    probe_mma_stats.launches += 1
    return out


probe_mma_stats.launches = 0

KERNELS = (probe_stats, probe_apply, probe_touch, probe_mma_stats)
