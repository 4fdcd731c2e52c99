"""GroupNorm+SiLU formulation microbench at the flagship hot shape.

Port of `scripts/membench2.py`: the same reductions and GroupNorm(32)+SiLU
formulations on a channels-last (B, R, R, C) bf16 activation, default
(8, 256, 256, 128), each timed with CUDA events over `iters` calls:

  reduce_full        sum(x^2) over everything
  reduce_spatial     per-channel sums over (H, W) -> (B, C)
  reduce_dot         per-channel sums as a ones . x matrix product (torch.matmul)
  gn_flax_fwd        group-reshape mean/var (what flax's GroupNorm computes)
  gn_chan_fwd        per-channel sum/sumsq + O(B*C) group combine
  gn_chan_dot_fwd    the same with the sums as matrix products
  gn_*_vjp           the input gradient of sum(SiLU(GN(x))) per formulation, by autograd
  kernel_fwd         the port's K2 forward (K2a's CUDA launch + Triton apply, ops/groupnorm.py)
  kernel_vjp         the port's `groupnorm_silu` autograd.Function, forward and
                     backward: the formulation the port's U-Net runs

    python -m nshmc_tpu_torch.scripts.membench2 [B] [R] [C] [iters]
        [--device cuda] [--out PATH]

Each case prints one JSON line: seconds per call and the GB/s of the
model traffic the JAX bench counts (1, 2 or 5 passes over x: a reduction
reads x; a forward reads x and writes y; a gradient reads x twice, the
cotangent once, and writes y and dx), with its share of the 3,350 GB/s
data-sheet rate. Eager PyTorch materializes the fp32 temporaries that XLA
fused, so the plain formulations move more than this count. In PyTorch a
bf16 matrix product returns bf16, so the `dot` sums are rounded to bf16
where the JAX bench kept fp32. `--device cpu` runs every case once and
prints null times; without it, a host with no card raises.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import groupnorm as gn
from ._bench import card, rate, resolve_device, time_s

GROUPS = 32
EPS = 1e-5


def silu(y: torch.Tensor) -> torch.Tensor:
    return y * torch.sigmoid(y)


def gn_flax(x, scale, bias, groups: int = GROUPS):
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xf - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    return silu(y * scale + bias).to(x.dtype)


def chan_stats_reduce(x):
    xf = x.float()
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def chan_sum_dot(x):
    """(B, C) channel sums as ones(H*W) . x."""
    xr = x.reshape(x.shape[0], -1, x.shape[-1])
    ones = torch.ones((1, xr.shape[1]), dtype=x.dtype, device=x.device)
    return torch.matmul(ones, xr)[:, 0].float()


def chan_stats_dot(x):
    """Sums and sums of squares as contractions over the spatial axis
    (the JAX bench's dot_generals: ones . x and the diagonal of x^T x)."""
    xr = x.reshape(x.shape[0], -1, x.shape[-1])
    return chan_sum_dot(x), torch.einsum("bsc,bsc->bc", xr, xr).float()


def gn_from_chan(x, s, s2, scale, bias, groups: int = GROUPS):
    b, c = x.shape[0], x.shape[-1]
    n = x[0, ..., 0].numel() * (c // groups)
    mean = s.reshape(b, groups, -1).sum(-1) / n
    var = s2.reshape(b, groups, -1).sum(-1) / n - mean**2
    inv = torch.rsqrt(var + EPS)
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    mean_c = mean.repeat_interleave(c // groups, dim=1).reshape(shape)
    inv_c = inv.repeat_interleave(c // groups, dim=1).reshape(shape)
    return silu((x.float() - mean_c) * inv_c * scale + bias).to(x.dtype)


def gn_chan(x, scale, bias, groups: int = GROUPS):
    return gn_from_chan(x, *chan_stats_reduce(x), scale, bias, groups)


def gn_chan_dot(x, scale, bias, groups: int = GROUPS):
    return gn_from_chan(x, *chan_stats_dot(x), scale, bias, groups)


def gn_kernel(x, scale, bias, groups: int = GROUPS):
    return gn.groupnorm_silu(x, scale, bias, groups, EPS)


FORMULATIONS = {"gn_flax": gn_flax, "gn_chan": gn_chan, "gn_chan_dot": gn_chan_dot,
                "kernel": gn_kernel}


def input_grad(fn, x, scale, bias):
    """d/dx of sum(fn(x)) in fp32, by autograd."""
    xg = x.detach().requires_grad_(True)
    return torch.autograd.grad(fn(xg, scale, bias).float().sum(), xg)[0]


def cases(x, scale, bias) -> dict:
    """{case: (callable, passes over x of model traffic)}."""
    def fwd(fn):
        def run():
            with torch.no_grad():
                return fn(x, scale, bias)
        return run

    out = {
        "reduce_full": (lambda: (x.float() ** 2).sum(), 1),
        "reduce_spatial": (lambda: x.float().sum(dim=(1, 2)).sum(), 1),
        "reduce_dot": (lambda: chan_sum_dot(x).sum(), 1),
    }
    for name in ("gn_flax", "gn_chan", "gn_chan_dot"):
        out[f"{name}_fwd"] = (fwd(FORMULATIONS[name]), 2)
    for name in ("gn_flax", "gn_chan", "gn_chan_dot"):
        out[f"{name}_vjp"] = (lambda f=FORMULATIONS[name]: input_grad(f, x, scale, bias), 5)
    out["kernel_fwd"] = (fwd(gn_kernel), 2)
    out["kernel_vjp"] = (lambda: input_grad(gn_kernel, x, scale, bias), 5)
    return out


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nshmc_tpu_torch.scripts.membench2",
                                description=__doc__.split("\n\n")[0])
    for name, default in (("B", 8), ("R", 256), ("C", 128), ("iters", 30)):
        p.add_argument(name, type=int, nargs="?", default=default)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write every result to this JSON file")
    return p


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.B, args.R, args.R, args.C), generator=g, device=dev).to(torch.bfloat16)
    scale = torch.ones((args.C,), device=dev)
    bias = torch.zeros((args.C,), device=dev)
    nbytes = x.numel() * x.element_size()
    results = {}
    for name, (fn, passes) in cases(x, scale, bias).items():
        s = time_s(fn, dev, args.iters)
        gb_s, pct = rate(passes * nbytes, s)
        results[name] = {"s_per_iter": s, "model_gb_s": gb_s, "pct_of_3350_gb_s": pct}
        print(json.dumps({"case": name, **results[name]}), flush=True)
    card_line = card(dev)
    print(card_line)
    result = {"shape": [args.B, args.R, args.R, args.C], "iters": args.iters,
              "device": str(dev), "card": card_line, "cases": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
