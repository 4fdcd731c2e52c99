"""Streaming-bandwidth probe at the GroupNorm hot shape (8, 65536, 128) bf16.

Port of `scripts/pallas_stream_probe.py` (`main()` and `extra_probes()`):
the four probe kernels P1-P4 (`ops/stream_probe.py`, CUDA C++), the port's
GroupNorm kernels (K2a's one CUDA launch, K2b in Triton) and plain PyTorch,
each reading the same
134 MB input, which is larger than the 50 MB L2, so every call reads it
from device memory.

    python -m nshmc_tpu_torch.scripts.stream_probe [--iters 30]
        [--shape 8,65536,128] [--device cuda] [--out PATH]

First each kernel is held against its plain version (tolerances below);
then every case is timed with CUDA events over `iters` back-to-back calls
after a warm-up and printed as one JSON line: seconds per call, the
effective GB/s of the traffic the JAX probe counts (NB = B*R*C*2 bytes for
the stats and read cases, 2 NB for the apply pass, 3 NB for a whole
GroupNorm+SiLU forward) and its share of the 3,350 GB/s data-sheet rate.
The last lines are the launch counts of the timed cases and the card's name
and power limit. `--device cpu` runs the check and every case once and
prints null times; without it, a host with no card raises. Nothing is
written unless `--out` is given.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import groupnorm as gn
from ..ops import stream_probe as sp
from ._bench import card, rate, resolve_device, time_s

# Tolerances of the kernels against their plain versions, with their reasons.
TOLERANCES = {
    # fp32 sums of R values, taken in another order: |d| <= 1e-5 x max|sum|,
    # for sum x and sum x^2 separately
    "stats": 1e-5,
    # bf16 output of the same fp32 math: one bf16 ulp (2^-7 |y|) + 2^-12
    "apply": (2.0**-7, 2.0**-12),
}


def make_inputs(shape, device: str = "cuda"):
    """x: (B, R, C) bf16 with a different mean and spread per channel, so a
    kernel that mixes up channels disagrees; scale, bias: (C,) fp32. Made
    from seed 0 on the device."""
    b, r, c = shape
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    mean = 2 * torch.rand((c,), generator=g, device=dev) - 1
    std = 0.5 + torch.rand((c,), generator=g, device=dev)
    x = (torch.randn((b, r, c), generator=g, device=dev) * std + mean).to(torch.bfloat16)
    scale = 1 + 0.3 * torch.randn((c,), generator=g, device=dev)
    bias = 0.3 * torch.randn((c,), generator=g, device=dev)
    return x, scale, bias


def stats_check(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, within the stats tolerance) for (B, 2, C) sums."""
    d = (got - ref).abs()
    per_stat = d.amax(dim=(0, 2)) <= TOLERANCES["stats"] * ref.abs().amax(dim=(0, 2))
    return float(d.max()), bool(per_stat.all())


def check_kernels(x, scale, bias) -> dict:
    """Each probe kernel against its plain version on the same inputs:
    {wrapper name: {"max_abs_err", "tolerance", "ok"}}."""
    st_plain = gn.channel_stats_plain(x)
    out = {}
    for fn in (sp.probe_stats, sp.probe_mma_stats):
        err, ok = stats_check(fn(x), st_plain)
        out[fn.__name__] = {"max_abs_err": err, "ok": ok,
                            "tolerance": "|d| <= 1e-5 max|sum|, per statistic"}
    mean_c, inv_c = gn.group_combine(st_plain, x.shape[1])
    y_k = sp.probe_apply(x, mean_c, inv_c, scale, bias).float()
    y_p = gn.normalize_silu_plain(x, mean_c, inv_c, scale, bias).float()
    d = (y_k - y_p).abs()
    ulp, floor = TOLERANCES["apply"]
    out["probe_apply"] = {"max_abs_err": float(d.max()), "tolerance": "2^-7 |y| + 2^-12",
                          "ok": bool((d <= ulp * y_p.abs() + floor).all())}
    t_k, t_p = sp.probe_touch(x), sp.touch_plain(x)
    out["probe_touch"] = {"max_abs_err": float((t_k - t_p).abs().max()), "tolerance": "exact",
                          "ok": bool(torch.equal(t_k, t_p))}
    return out


def matmul_stats(x: torch.Tensor) -> torch.Tensor:
    """P4's library yardstick: ones(1, R) . x and ones(1, R) . x^2 as two
    torch.matmul calls (cuBLAS; the first rounds its sums to bf16)."""
    ones = torch.ones((1, x.shape[1]), dtype=x.dtype, device=x.device)
    return torch.cat([torch.matmul(ones, x).float(),
                      torch.matmul(ones.float(), x.float() ** 2)], dim=1)


def cases(x, scale, bias) -> dict:
    """{case: (callable, traffic in bytes as the JAX probe counts it)}."""
    b, r, c = x.shape
    nb = b * r * c * x.element_size()
    mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r)

    def cuda_gn_fwd():
        m, i = gn.group_combine(sp.probe_stats(x), r)
        return sp.probe_apply(x, m, i, scale, bias)

    def kernel_gn_fwd():
        with torch.no_grad():
            return gn.groupnorm_silu(x, scale, bias)

    return {
        "torch_stats": (lambda: gn.channel_stats_plain(x), nb),
        "k2a_stats": (lambda: gn.channel_stats(x), nb),
        "cuda_stats": (lambda: sp.probe_stats(x), nb),
        "cuda_mma_stats": (lambda: sp.probe_mma_stats(x), nb),
        "torch_matmul_stats": (lambda: matmul_stats(x), nb),
        "cuda_dma_read": (lambda: sp.probe_touch(x), nb),
        "torch_apply": (lambda: gn.normalize_silu_plain(x, mean_c, inv_c, scale, bias), 2 * nb),
        "cuda_apply": (lambda: sp.probe_apply(x, mean_c, inv_c, scale, bias), 2 * nb),
        "torch_gn_fwd": (lambda: gn.groupnorm_silu_plain(x, scale, bias), 3 * nb),
        "kernel_gn_fwd": (kernel_gn_fwd, 3 * nb),
        "cuda_gn_fwd": (cuda_gn_fwd, 3 * nb),
    }


def time_cases(x, scale, bias, iters: int) -> dict:
    """{case: {"s_per_iter", "eff_gb_s", "pct_of_3350_gb_s"}}; None times
    on the CPU."""
    out = {}
    for name, (fn, traffic) in cases(x, scale, bias).items():
        s = time_s(fn, x.device, iters)
        gb_s, pct = rate(traffic, s)
        out[name] = {"s_per_iter": s, "eff_gb_s": gb_s, "pct_of_3350_gb_s": pct}
    return out


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nshmc_tpu_torch.scripts.stream_probe",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--shape", default="8,65536,128", help="B,R,C")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write every result to this JSON file")
    return p


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    dev = resolve_device(args.device)
    x, scale, bias = make_inputs(shape, device=args.device)
    checks = check_kernels(x, scale, bias)
    for name, res in checks.items():
        print(json.dumps({"check": name, **res}), flush=True)
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"stream probe: {bad} disagree with their plain versions")
    for fn in sp.KERNELS:
        fn.launches = 0
    timed = time_cases(x, scale, bias, args.iters)
    launches = {fn.__name__: fn.launches for fn in sp.KERNELS}
    for name, res in timed.items():
        print(json.dumps({"case": name, **res}), flush=True)
    print(json.dumps({"launches": launches}))
    card_line = card(dev)
    print(card_line)
    result = {"shape": list(shape), "iters": args.iters, "device": str(dev), "card": card_line,
              "checks": checks, "cases": timed, "launches": launches}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
