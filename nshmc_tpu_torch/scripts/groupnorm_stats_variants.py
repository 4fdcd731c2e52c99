"""The statistics half of a GroupNorm site (K2a and the group combine) timed
on the card, four ways, at every K2a site shape of the three paths:

  - "new": `group_stats`, one launch of csrc/groupnorm_stats.cu;
  - "triton_chain": the statistics as the port computed them before that
    launch: the Triton stats kernel (its source is kept here, as it was in
    ops/groupnorm.py), `part.sum` over its row partials and `group_combine`
    (about 14 launches);
  - "p1_chain": the stats probe P1's partial and finish kernels
    (csrc/stream_probe.cu, bf16 only) followed by `group_combine`;
  - "var_mean": `torch.var_mean(x, dim=1, correction=0)`, the one library
    call that gives per-channel statistics (not the group combine).

    python -m nshmc_tpu_torch.scripts.groupnorm_stats_variants [--iters N] [--out PATH]

Sites (kernel_check): the flagship's GN+SiLU and GroupNorm32 shapes in bf16,
the latent path's (the VQ decoder's at eps 1e-6, the latent U-Net's) in
bf16 and f32. At each, the new launch is first held to its plain version
(`kernel_check.gn_stats_check`), then every way is timed from CUDA graphs of
--iters calls (device ms, the host's launch cost left out) and eagerly (CUDA
events over back-to-back calls: what the host pays). The new launch is also
timed at another plan (slabs for 4 CTAs an SM, `stats_plan`'s default 2)
beside the default, and a copy of csrc/groupnorm_stats.cu that differs in one line
(`SOURCE_VARIANTS`, built in a temporary directory; it must give the same
bits). One JSON line per case with the bound (x read once and the
B x 4C fp32 outputs written once, at 3.35 TB/s), then a summary line: whether
the new launch is no slower than the Triton chain at every site, the
targets at (8, 65536, 128) bf16 and (8, 4096, 512) f32, and the sites with a
bound of at least 0.01 ms under half of it; last, the CUDA kernels one
call launches at (8, 65536, 128) bf16, counted by torch.profiler: the
statistics half by the new launch and by the Triton chain, and a whole
GN+SiLU forward site. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import tempfile

import torch

from ..ops import _build
from ..ops import groupnorm as gn
from ..ops import stream_probe as sp
from . import kernel_check as kc
from ._bench import HBM_GB_S, card, resolve_device, time_s, time_s_graph

_TILE = 8192            # elements per Triton program tile
_STATS_PROGRAMS = 1024  # target programs in the Triton stats grid
OTHER_CTAS_PER_SM = 4  # the plan's slabs aimed at 4 CTAs an SM, beside the default 2
HOT_TARGET_MS = 0.0530  # the stats probe P1 at (8, 65536, 128) bf16, H100 (PERF.md)
# copies of csrc/groupnorm_stats.cu that differ in one line: the kernel
# compiled without the hint of two blocks an SM (the compiler then picks its
# own register budget)
SOURCE_VARIANTS = {
    "no_min_blocks": ("__global__ void __launch_bounds__(THREADS, 2)\n",
                      "__global__ void __launch_bounds__(THREADS)\n"),
}


@functools.lru_cache(maxsize=None)
def _triton_stats_kernel():
    """The Triton stats kernel that computed K2a before the one launch."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_build.BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, part_ptr, R, C, rows_per_prog, n_rb,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        rb = tl.program_id(0)
        cb = tl.program_id(1)
        b = tl.program_id(2).to(tl.int64)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc = tl.zeros((BLOCK_R, BLOCK_C), tl.float32)
        acc2 = tl.zeros((BLOCK_R, BLOCK_C), tl.float32)
        row0 = rb * rows_per_prog
        xb = x_ptr + b * R * C
        for r in range(0, rows_per_prog, BLOCK_R):
            rows = row0 + r + tl.arange(0, BLOCK_R)
            mask = (rows < R)[:, None] & cmask[None, :]
            x = tl.load(xb + rows[:, None].to(tl.int64) * C + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            acc += x
            acc2 += x * x
        out = part_ptr + ((b * n_rb + rb) * 2) * C
        tl.store(out + cols, tl.sum(acc, axis=0), mask=cmask)
        tl.store(out + C + cols, tl.sum(acc2, axis=0), mask=cmask)

    return triton, stats_kernel


def triton_chain(x: torch.Tensor, num_groups: int = gn.NUM_GROUPS, eps: float = gn.EPS):
    """(sums, mean_c, inv_c) as the port computed them before the one
    launch: the Triton stats kernel (counted in `.launches`), `part.sum`
    and `group_combine`. CUDA tensors only."""
    b, r, c = x.shape
    triton, stats_kernel = _triton_stats_kernel()
    block_c = min(128, triton.next_power_of_2(c))
    block_r = max(1, _TILE // block_c)
    n_cb = triton.cdiv(c, block_c)
    row_tiles = triton.cdiv(r, block_r)
    per_bc = max(1, min(row_tiles, triton.cdiv(_STATS_PROGRAMS, b * n_cb)))
    rows_per_prog = triton.cdiv(row_tiles, per_bc) * block_r
    n_rb = triton.cdiv(r, rows_per_prog)
    part = torch.empty((b, n_rb, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stats_kernel[(n_rb, n_cb, b)](x, part, r, c, rows_per_prog, n_rb,
                                      BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8)
    triton_chain.launches += 1
    sums = part.sum(dim=1)
    return (sums, *gn.group_combine(sums, r, num_groups, eps))


triton_chain.launches = 0


def p1_chain(x: torch.Tensor, num_groups: int = gn.NUM_GROUPS, eps: float = gn.EPS):
    """P1's two launches, then `group_combine` (bf16 only; counts no launch)."""
    sums = sp.stats_launch(x, "nshmc_probe_stats")
    return (sums, *gn.group_combine(sums, x.shape[1], num_groups, eps))


def build_variant(name: str, tmp: str):
    """The variant's declared C launcher, compiled in `tmp` with the port's
    nvcc flags, and its ptxas lines."""
    with open(os.path.join(_build.CSRC, "groupnorm_stats.cu")) as f:
        src = f.read()
    old, new = SOURCE_VARIANTS[name]
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the line to replace is not in csrc/groupnorm_stats.cu")
    cu, so = os.path.join(tmp, f"stats_{name}.cu"), os.path.join(tmp, f"stats_{name}.so")
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {name} copy:\n{r.stderr}")
    return gn.declare_stats(ctypes.CDLL(so).nshmc_gn_stats), _build.ptxas_summary(r.stderr)


def sites():
    """[(path, shape, dtype, eps)] at every K2a site shape of the three paths."""
    flagship = [*kc.FLAGSHIP_GN_SITES, *kc.FLAGSHIP_NORM_SITES]
    latent = ([(s, 1e-6) for s in [*kc.VQ_DECODER_GN_SITES, *kc.VQ_DECODER_NORM_SITES]]
              + [(s, 1e-5) for s in [*kc.LATENT_UNET_GN_SITES, *kc.LATENT_UNET_NORM_SITES]])
    out = [("flagship", s, torch.bfloat16, 1e-5) for s in dict.fromkeys(flagship)]
    for dt in (torch.bfloat16, torch.float32):
        out += [("latent", s, dt, eps) for s, eps in dict.fromkeys(latent)]
    return out


def bound_ms(shape, elem_size: int) -> float:
    """x read once and the (B, 2, C) sums and two (B, C) fp32 outputs
    written once, at 3.35 TB/s (three fp32 operations an element are far
    below the card's 67 TFLOP/s)."""
    b, r, c = shape
    return 1e3 * (b * r * c * elem_size + b * 4 * c * 4) / (HBM_GB_S * 1e9)


def stats_times(x, eps, iters: int = 20) -> dict:
    """Device ms (CUDA graphs) and eager ms of each way at x."""
    dev = x.device
    ways = {"new": lambda: gn.group_stats(x, gn.NUM_GROUPS, eps),
            "triton_chain": lambda: triton_chain(x, gn.NUM_GROUPS, eps),
            "var_mean": lambda: torch.var_mean(x, dim=1, correction=0),
            "plain": lambda: gn.group_stats_plain(x, gn.NUM_GROUPS, eps)}
    if x.dtype == torch.bfloat16:
        ways["p1_chain"] = lambda: p1_chain(x, gn.NUM_GROUPS, eps)
    out = {}
    for name, fn in ways.items():
        out[f"{name}_ms"] = 1e3 * time_s_graph(fn, iters=iters, reps=3)
        if name != "plain":
            out[f"{name}_eager_ms"] = 1e3 * time_s(fn, dev, iters, warmup=3)
    return out


def time_case(path, shape, dt, eps, gen, dev, sms: int, iters: int, copies: dict) -> dict:
    x = (1.5 * torch.randn(shape, generator=gen, device=dev) + 0.3).to(dt)
    check = kc.gn_stats_check(x, gn.NUM_GROUPS, eps, gen)
    rec = {"path": path, "shape": list(shape), "dtype": str(dt).split(".")[1], "eps": eps,
           "agrees": check["ok"], "plan": vars(gn.stats_plan(*shape, dt.itemsize, sms))}
    rec.update(stats_times(x, eps, iters))
    plan = gn.stats_plan(*shape, dt.itemsize, sms)
    other = gn.stats_plan(*shape, dt.itemsize, sms, OTHER_CTAS_PER_SM)
    rec[f"new_c{OTHER_CTAS_PER_SM}_ms"] = 1e3 * time_s_graph(
        lambda: gn.launch_stats(x, other, gn.NUM_GROUPS, eps), iters=iters, reps=3)
    want = gn.group_stats(x, gn.NUM_GROUPS, eps)
    for name, fn in copies.items():  # the same order of summation: the same bits
        got = gn.launch_stats(x, plan, gn.NUM_GROUPS, eps, fn)
        rec[f"{name}_same_bits"] = all(torch.equal(a, b) for a, b in zip(got, want))
        rec["agrees"] = rec["agrees"] and rec[f"{name}_same_bits"]
        rec[f"{name}_ms"] = 1e3 * time_s_graph(
            lambda: gn.launch_stats(x, plan, gn.NUM_GROUPS, eps, fn), iters=iters, reps=3)
    rec["bound_ms"] = bound_ms(shape, dt.itemsize)
    rec["bound_share"] = rec["bound_ms"] / rec["new_ms"]
    rec["no_slower_than_triton_chain"] = rec["new_ms"] <= rec["triton_chain_ms"]
    return rec


def kernels_per_call(fn) -> int:
    """The CUDA kernels one call of fn launches, counted by torch.profiler
    (after one untraced call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def profiler_launches(dev, shape=(8, 65536, 128)) -> dict:
    """Kernels a call launches at `shape` in bf16: the statistics half of a
    site (the one launch, the Triton chain it replaced) and a whole
    GN+SiLU forward site with a (B, C) affine (the one launch and K2b)."""
    x = torch.randn(shape, device=dev).to(torch.bfloat16)
    sc, bi = torch.ones((shape[0], shape[2]), device=dev), torch.zeros((shape[0], shape[2]),
                                                                          device=dev)
    with torch.no_grad():
        return {"new": kernels_per_call(lambda: gn.group_stats(x)),
                "triton_chain": kernels_per_call(lambda: triton_chain(x)),
                "gn_silu_forward_site": kernels_per_call(lambda: gn.groupnorm_silu(x, sc, bi))}


def summary(records) -> dict:
    """Whether the new launch is no slower than the Triton chain everywhere,
    and the targets."""
    by = {(tuple(r["shape"]), r["dtype"]): r for r in records}
    hot, vq = by[((8, 65536, 128), "bfloat16")], by[((8, 4096, 512), "float32")]
    under = [(r["shape"], r["dtype"], round(r["bound_share"], 3)) for r in records
             if r["bound_ms"] >= 0.01 and r["bound_share"] < 0.5]
    return {"cases": len(records), "all_agree": all(r["agrees"] for r in records),
            "no_slower_than_triton_chain_everywhere":
                all(r["no_slower_than_triton_chain"] for r in records),
            "slower_than_triton_chain": [(r["shape"], r["dtype"]) for r in records
                                         if not r["no_slower_than_triton_chain"]],
            "hot_bf16_ms": hot["new_ms"], "hot_bf16_at_most_p1": hot["new_ms"] <= HOT_TARGET_MS,
            "vq_f32_ms": vq["new_ms"], "vq_f32_bound_share": vq["bound_share"],
            "sites_bound_ge_0.01ms_under_half": under}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20, help="calls a CUDA graph (default 20)")
    ap.add_argument("--out", help="also write the records as JSON lines here")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if dev.type != "cuda":
        raise RuntimeError("groupnorm_stats_variants times kernels on a CUDA card only")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    print(card(dev))
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        copies = {}
        for name in SOURCE_VARIANTS:
            copies[name], report = build_variant(name, tmp)
            for line in report:
                print(f"[{name}] {line}")
        for path, shape, dt, eps in sites():
            rec = time_case(path, shape, dt, eps, gen, dev, sms, args.iters, copies)
            print(json.dumps(rec))
            records.append(rec)
    print(f"K2a variants summary: {json.dumps(summary(records))}")
    print(f"CUDA kernels a call launches (torch.profiler) at (8, 65536, 128) bf16: "
          f"{json.dumps(profiler_launches(dev))}")
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)
    return records


if __name__ == "__main__":
    main()
