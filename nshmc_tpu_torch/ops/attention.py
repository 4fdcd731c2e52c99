"""Spatial self-attention for the U-Net attention blocks (kernel K1).

Port of `nshmc_tpu/ops/attention.py`. The function is QKVAttentionLegacy's:
q and k are pre-scaled by ch^-1/4 in their own dtype, the logits and the
softmax are fp32, the weights are cast to v's dtype before the PV product.

  - `attention_plain`: the plain PyTorch version, the numerics of the Pallas
    kernel `_attn_kernel` (nshmc_tpu/ops/attention.py:44). CPU tensors only.
  - `attention_forward`: the wrapper. A CUDA tensor launches a
    hand-written kernel of `csrc/attention.cu` (see its header for what
    bounds it on Hopper and how its design answers), chosen by dtype: bf16
    runs the two-pass tensor-core kernel, f32 the one-pass online-softmax
    kernel on tensor cores in 3xTF32 (each product as three TF32 `mma.sync`
    m16n8k8 products of hi/lo splits, which keeps fp32 accuracy where one
    TF32 product would break the 1e-4 f32 tolerance). The bf16 kernel has
    two designs, which the C launcher picks by T alone (`bf16_design`): up
    to TC_RES_MAX_T tokens K and V stay in shared memory (`mma.sync`
    m16n8k16, `cp.async`, `ldmatrix`), above it they stream through a TMA
    ring to two `wgmma` consumer warpgroups. A CPU tensor takes the plain
    version; anything else raises. `attention_forward.launches` counts
    kernel launches of either kernel, `KERNEL_LAUNCHES[dtype].launches` those
    of the dtype's own, and `LONG_LAUNCHES.launches` the bf16 launches of
    the long-sequence design.
  - `attention`: the `torch.autograd.Function` around the wrapper. Its
    backward recomputes the softmax in plain torch ops, a line-for-line
    translation of `_attention_bwd` (nshmc_tpu/ops/attention.py:108-121),
    which is XLA code on the TPU too; the residuals are q, k, v only.

q, k and v arrive as strided views of one (B, T, H, 3, ch) qkv tensor. The
kernels take their common strides, so the split costs no copy; views with
differing strides are made contiguous first. Both kernels copy 16-byte row
chunks (the long-sequence design reads them through TMA tensor maps over
the same strides), so the wrapper checks that the three pointers are
16-byte aligned and the strides multiples of 16 bytes (8 bf16 or 4 f32
elements), and raises otherwise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_CHANNELS = (16, 32, 64)
# csrc/attention.cu's TC_RES_MAX_T: the longest sequence the bf16 kernel's
# resident design takes; longer ones take the long-sequence design
TC_RES_MAX_T = 256


def bf16_design(t_len: int) -> str:
    """The design of the bf16 kernel that a call over `t_len` tokens runs:
    "resident" or "long", as the C launcher picks it."""
    return "resident" if t_len <= TC_RES_MAX_T else "long"


def _scale_in(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x * scale with the scale rounded to x's dtype first, as a JAX weak
    Python scalar is (bf16 * bf16 is exact in fp32, so this rounds once)."""
    return x * torch.tensor(scale, dtype=x.dtype)


def declare(fn):
    """Declare the argument and result types of `nshmc_attention_fwd` of a
    library built from csrc/attention.cu."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_float, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher of csrc/attention.cu, built and loaded at first use."""
    return declare(_build.load("attention.cu").nshmc_attention_fwd)


def attention_weights_plain(q: torch.Tensor, k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The normalized weights (B, H, T, T), fp32 logits and softmax, cast to
    `dtype` (v's) before the PV product."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.einsum("bthc,bshc->bhts", _scale_in(q, scale).float(),
                          _scale_in(k, scale).float())
    return torch.softmax(logits, dim=-1).to(dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, ch) -> (B, T, H, ch), plain PyTorch."""
    weights = attention_weights_plain(q, k, v.dtype)
    out = torch.einsum("bhts,bshc->bthc", weights.float(), v.float())
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_scale(ch: int, dtype: torch.dtype) -> float:
    """ch^-1/4 rounded to dtype, as the kernels take it."""
    return float(torch.tensor(1.0 / math.sqrt(math.sqrt(ch)), dtype=dtype))


def launch(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Check CUDA q, k, v and run `fn`, a C launcher with the interface of
    `nshmc_attention_fwd`; counts no launch."""
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"attention: shapes {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise TypeError(f"attention: dtype {q.dtype} (float32/bfloat16 only)")
    b, t, h, ch = q.shape
    if ch not in _HEAD_CHANNELS:
        raise ValueError(f"attention: head channels {ch} not in {_HEAD_CHANNELS}")
    if not (q.stride() == k.stride() == v.stride() and q.stride(-1) == 1):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not (q.device == k.device == v.device):
        raise ValueError("attention: q, k, v on different devices")
    sb, st, sh, _ = q.stride()
    per_chunk = 16 // q.element_size()  # elements in a 16-byte copy
    if any(x.data_ptr() % 16 for x in (q, k, v)) or any(s_ % per_chunk for s_ in (sb, st, sh)):
        raise ValueError(f"attention: {q.dtype} views must be 16-byte aligned with strides "
                         f"in multiples of {per_chunk}, got strides {q.stride()}")
    out = torch.empty((b, t, h, ch), dtype=q.dtype, device=q.device)
    scale = _kernel_scale(ch, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, t, h, ch, sb, st, sh, scale, stream)
    _build.check(rc, "nshmc_attention_fwd")
    return out


class LaunchCount:
    """One kernel's launch count, `launches`."""

    def __init__(self, name: str):
        self.__name__, self.launches = name, 0


# each kernel of csrc/attention.cu by the dtype that picks it
KERNEL_LAUNCHES = {torch.bfloat16: LaunchCount("attn_fwd_tc_kernel"),
                   torch.float32: LaunchCount("attn_fwd_f32_kernel")}
# the bf16 kernel's launches of its long-sequence design (T > TC_RES_MAX_T)
LONG_LAUNCHES = LaunchCount("attn_fwd_tc_long")


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Forward attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    out = launch(_launcher(), q, k, v)
    attention_forward.launches += 1
    KERNEL_LAUNCHES[q.dtype].launches += 1
    if q.dtype == torch.bfloat16 and bf16_design(q.shape[1]) == "long":
        LONG_LAUNCHES.launches += 1
    return out


attention_forward.launches = 0


def attention_backward(q, k, v, g):
    """Recompute-softmax VJP of the attention, (dq, dk, dv) in the input
    dtypes (nshmc_tpu/ops/attention.py:108-121, in torch ops)."""
    scale2 = 1.0 / math.sqrt(q.shape[-1])  # (ch^-1/4)^2
    z = _scale_in(torch.einsum("bthc,bshc->bhts", q, k), scale2)
    w = torch.softmax(z.float(), dim=-1)
    g32 = g.float()
    dv = torch.einsum("bhts,bthc->bshc", w, g32)
    dw = torch.einsum("bthc,bshc->bhts", g32, v.float())
    dz = w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))
    dq = torch.einsum("bhts,bshc->bthc", dz, k.float()) * scale2
    dk = torch.einsum("bhts,bthc->bshc", dz, q.float()) * scale2
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attention_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return attention_backward(q, k, v, g)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable fused attention, q/k/v: (B, T, H, ch)."""
    return _Attention.apply(q, k, v)
