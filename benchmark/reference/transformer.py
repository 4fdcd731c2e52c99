"""Stable Diffusion 2's SpatialTransformer as plain PyTorch (Stability-AI/
stablediffusion, ldm/modules/attention.py, with use_linear_in_transformer),
float32 by default: GroupNorm(32, eps 1e-6) -> a linear proj_in on the
tokens -> `depth` BasicTransformerBlocks (LayerNorm eps 1e-5 -> self-
attention; LayerNorm -> cross-attention over the context; LayerNorm ->
GEGLU feed-forward, 4x wide, exact GELU; each residual) -> a linear
proj_out, plus the input. Parameter names are the checkpoint's keys.

Attention is SD 2's own: softmax(q k^T d^-1/2) with the logits and the
softmax in float32. The program scales q and k by d^-1/4 each before the
product instead (the JAX package's and its attention kernel's form): the
same product up to rounding."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import Numerics


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, nm: Numerics) -> torch.Tensor:
    return nm.act(F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps))


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context, nm: Numerics):
        ctx = x if context is None else context
        b, t, _ = x.shape
        s, h, d = ctx.shape[1], self.heads, self.dim_head
        split = lambda m, a, n: nm.act(nm.linear(m, a)).view(b, n, h, d).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.to_q, x, t), split(self.to_k, ctx, s), split(self.to_v, ctx, s)
        w = torch.softmax(nm.matmul(q, k.transpose(-1, -2)).float() * d ** -0.5, dim=-1)
        out = nm.act(nm.matmul(w, v)).transpose(1, 2).reshape(b, t, h * d)
        return nm.act(nm.linear(self.to_out[0], out))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x, nm: Numerics):
        a, gate = nm.act(nm.linear(self.proj, x)).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x, nm: Numerics):
        return nm.act(nm.linear(self.net[2], self.net[0](x, nm)))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x, context, nm: Numerics):
        x = self.attn1(layer_norm(self.norm1, x, nm), None, nm) + x
        x = self.attn2(layer_norm(self.norm2, x, nm), context, nm) + x
        return self.ff(layer_norm(self.norm3, x, nm), nm) + x


class SpatialTransformer(nn.Module):
    """forward(x (B, C, H, W), context (B, S, context_dim)) -> like x."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context, nm: Numerics):
        b, c, hh, ww = x.shape
        h = nm.act(F.group_norm(x.float(), 32, self.norm.weight, self.norm.bias, self.norm.eps))
        tokens = nm.act(nm.linear(self.proj_in, h.reshape(b, c, hh * ww).transpose(1, 2)))
        for block in self.transformer_blocks:
            tokens = block(tokens, context, nm)
        tokens = nm.act(nm.linear(self.proj_out, tokens))
        return x + tokens.transpose(1, 2).reshape(b, c, hh, ww)
