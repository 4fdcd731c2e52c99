"""Cross-attention SpatialTransformer stack for conditional U-Nets (port of
nshmc_tpu/models/ldm/transformer.py).

What `UNetConfig(context_dim=...)` puts at the U-Net's attention sites in
place of AttentionBlock: GroupNorm -> 1x1 proj_in -> `depth` pre-norm
transformer blocks (self-attention, cross-attention over the context,
GEGLU feedforward) -> 1x1 proj_out, plus the input. With `use_linear`
(Stable Diffusion 2's `use_linear_in_transformer`) proj_in and proj_out are
linear layers on the tokens, `proj_in.weight` (inner, C).

  - Parameter names are the reference's `state_dict` keys (norm, proj_in,
    transformer_blocks.{i}.attn{1,2}.to_{q,k,v} bias-free, to_out.0,
    ff.net.0.proj, ff.net.2, norm{1,2,3}, proj_out), so a reference
    checkpoint loads with `load_state_dict(strict=True)`;
    `spatial_transformer_state_dict_from_jax` is the inverse of
    nshmc_tpu/models/ldm/transformer.py::port_spatial_transformer.
  - Self-attention (`attn1`) goes through ops/attention.py::attention (the
    kernel K1 on the card, its plain version on the CPU; a head width K1
    does not take raises on the card); cross-attention (`attn2`, over the
    context's few tokens) is plain torch, as the JAX package's
    `attention_xla` (nshmc_tpu/ops/attention.py:35-41). Both scale q and k
    by d_head^-1/4 each in their own dtype, take the softmax in fp32 and
    cast the weights to v's dtype before the product.
  - `norm` is models/nn.py::GroupNorm32 at eps 1e-6, so its statistics run
    K2a on the card. The LayerNorms take eps 1e-5, torch's default and the
    reference block's; the JAX block uses flax's 1e-6 (ROADMAP.md Queue 3).
  - GELU is exact (erf). LayerNorms reduce in fp32, their output is cast to
    the compute dtype of the projections that read it.
  - Public tensors are NCHW channels_last, as inside the U-Net; the context
    is (B, S, context_dim).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import attention as k1
from ...utils import profiling
from ..nn import GroupNorm32, nchw, nhwc

NORM_EPS = 1e-6   # the SpatialTransformer's GroupNorm (the reference's Normalize)
LAYER_NORM_EPS = 1e-5


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


class GEGLU(nn.Module):
    """x * gelu(gate) from one 2x-wide projection."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU -> Linear, mult 4 (the reference's gated_ff, the only form any
    config uses). Keys: net.0.proj, net.2 (net.1 is the reference's inert
    dropout)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class CrossAttention(nn.Module):
    """Multi-head attention of x over the context (over x itself when the
    context is None); q/k/v projections bias-free, to_out.0 with bias."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.heads, self.dim_head
        if context is None:
            q, k, v = (f(x).view(b, t, h, d) for f in (self.to_q, self.to_k, self.to_v))
            return self.to_out(k1.attention(q, k, v).reshape(b, t, h * d))
        ctx = context.to(x.dtype)
        s = ctx.shape[1]
        q = self.to_q(x).view(b, t, h, d).transpose(1, 2).reshape(b * h, t, d)
        k = self.to_k(ctx).view(b, s, h, d).transpose(1, 2).reshape(b * h, s, d)
        v = self.to_v(ctx).view(b, s, h, d).transpose(1, 2).reshape(b * h, s, d)
        scale = torch.tensor(d ** -0.25, dtype=q.dtype)  # rounded like a JAX weak scalar
        w = torch.bmm(q * scale, (k * scale).transpose(1, 2))
        w = torch.softmax(w.float(), dim=-1).to(v.dtype)
        out = torch.bmm(w, v).view(b, h, t, d).transpose(1, 2).reshape(b, t, h * d)
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    """Pre-norm self-attention -> cross-attention -> feedforward, each
    residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads=n_heads, dim_head=d_head)
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.attn1.to_q.weight.dtype
        x = self.attn1(_layer_norm(self.norm1, x, dt)) + x
        x = self.attn2(_layer_norm(self.norm2, x, dt), context) + x
        return self.ff(_layer_norm(self.norm3, x, dt)) + x


class SpatialTransformer(nn.Module):
    """forward(x, context=None): x (B, C, H, W) channels_last -> same shape
    and dtype. `takes_context` tells the U-Net's TimestepBlock to pass the
    context on."""

    takes_context = True

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, use_linear: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.use_linear = use_linear
        self.norm = GroupNorm32(in_channels, eps=NORM_EPS)
        self.proj_in = (nn.Linear(in_channels, inner) if use_linear
                        else nn.Conv2d(in_channels, inner, 1))
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)])
        self.proj_out = (nn.Linear(inner, in_channels) if use_linear
                         else nn.Conv2d(inner, in_channels, 1))
        for p in self.proj_out.parameters():  # the reference's zero_module
            nn.init.zeros_(p)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        with profiling.span("ldm.transformer"):
            b, c, hh, ww = x.shape
            h = self.norm(x).to(self.proj_in.weight.dtype)
            if self.use_linear:
                tokens = self.proj_in(nhwc(h).reshape(b, hh * ww, c))
            else:
                tokens = nhwc(self.proj_in(h)).reshape(b, hh * ww, -1)
            for block in self.transformer_blocks:
                tokens = block(tokens, context)
            if self.use_linear:
                tokens = self.proj_out(tokens)
            h = nchw(tokens.view(b, hh, ww, -1)).contiguous(memory_format=torch.channels_last)
            return (h if self.use_linear else self.proj_out(h)) + x


def spatial_transformer_state_dict_from_jax(tree) -> Dict[str, np.ndarray]:
    """A JAX SpatialTransformer's params (the inner tree, leaves as numpy
    arrays) -> {reference key: array}, the inverse of
    port_spatial_transformer: Dense kernels (I, O) -> (O, I), 1x1 conv
    kernels (1, 1, I, O) -> (O, I, 1, 1), LayerNorm and GroupNorm scale ->
    weight."""
    tree = tree.get("params", tree)

    def lin(node, name, bias=True):
        out = {f"{name}.weight": np.asarray(node["kernel"]).T}
        if bias:
            out[f"{name}.bias"] = np.asarray(node["bias"])
        return out

    def norm(node, name):
        return {f"{name}.weight": np.asarray(node["scale"]),
                f"{name}.bias": np.asarray(node["bias"])}

    def conv1x1(node, name):
        return {f"{name}.weight": np.asarray(node["kernel"]).transpose(3, 2, 0, 1),
                f"{name}.bias": np.asarray(node["bias"])}

    sd = {**norm(tree["norm"], "norm"), **conv1x1(tree["proj_in"], "proj_in"),
          **conv1x1(tree["proj_out"], "proj_out")}
    i = 0
    while f"block_{i}" in tree:
        blk, tb = tree[f"block_{i}"], f"transformer_blocks.{i}."
        for n in ("norm1", "norm2", "norm3"):
            sd.update(norm(blk[n], tb + n))
        for a in ("attn1", "attn2"):
            for p in ("to_q", "to_k", "to_v"):
                sd.update(lin(blk[a][p], f"{tb}{a}.{p}", bias=False))
            sd.update(lin(blk[a]["to_out"], f"{tb}{a}.to_out.0"))
        sd.update(lin(blk["ff"]["in_proj"]["proj"], tb + "ff.net.0.proj"))
        sd.update(lin(blk["ff"]["out_proj"], tb + "ff.net.2"))
        i += 1
    return sd
