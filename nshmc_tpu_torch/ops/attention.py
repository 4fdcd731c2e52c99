"""Spatial self-attention for the U-Net attention blocks (kernel K1).

Port of `nshmc_tpu/ops/attention.py`. The function is QKVAttentionLegacy's:
q and k are pre-scaled by ch^-1/4 in their own dtype, the logits and the
softmax are fp32, the weights are cast to v's dtype before the PV product.

  - `attention_plain`: the plain PyTorch version, the numerics of the Pallas
    kernel `_attn_kernel` (nshmc_tpu/ops/attention.py:44). CPU tensors only.
  - `attention_forward`: the wrapper. A CUDA tensor launches the
    hand-written kernel `csrc/attention.cu` (see its header for what bounds
    it on Hopper and how its design answers); a CPU tensor takes the plain
    version; anything else raises. `attention_forward.launches` counts
    kernel launches.
  - `attention`: the `torch.autograd.Function` around the wrapper. Its
    backward recomputes the softmax in plain torch ops, a line-for-line
    translation of `_attention_bwd` (nshmc_tpu/ops/attention.py:108-121),
    which is XLA code on the TPU too; the residuals are q, k, v only.

q, k and v arrive as strided views of one (B, T, H, 3, ch) qkv tensor. The
kernel takes their common strides, so the split costs no copy; views with
differing strides are made contiguous first.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_CHANNELS = (16, 32, 64)


def _scale_in(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x * scale with the scale rounded to x's dtype first, as a JAX weak
    Python scalar is (bf16 * bf16 is exact in fp32, so this rounds once)."""
    return x * torch.tensor(scale, dtype=x.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher of csrc/attention.cu, built and loaded at first use."""
    fn = _build.load("attention.cu").nshmc_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_float, ctypes.c_void_p]
    return fn


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, ch) -> (B, T, H, ch), plain PyTorch."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.einsum("bthc,bshc->bhts", _scale_in(q, scale).float(),
                          _scale_in(k, scale).float())
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshc->bthc", weights.float(), v.float())
    return out.to(q.dtype)


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Forward attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
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
    out = torch.empty((b, t, h, ch), dtype=q.dtype, device=q.device)
    scale = float(torch.tensor(1.0 / math.sqrt(math.sqrt(ch)), dtype=q.dtype))
    sb, st, sh, _ = q.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         _DTYPES[q.dtype], b, t, h, ch, sb, st, sh, scale, stream)
    _build.check(rc, "nshmc_attention_fwd")
    attention_forward.launches += 1
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
