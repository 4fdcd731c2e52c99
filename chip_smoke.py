#!/usr/bin/env python3
"""Chip smoke run of nshmc_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --trace OUT_DIR  # profile one flagship evaluation instead

It builds the port's kernels from the sources in this checkout and then:
  1. holds the port's output against its plain-PyTorch path on the CPU on a
     small input (the tiny config's pixel loss and gradient, f32);
  2. drives the main path: the flagship pixel noise-space HMC through the
     port's engine — ADM U-Net at 256^2 (configs/ffhq.yaml, random weights
     from a seed), 3-step DDIM, 92% random inpainting, tau 1.0 / eps 0.05
     (L = 20), 8 chains as the batch, bf16 — for a few MH attempts, with every
     kernel's launch count set to 0 just before and read just after. The
     anneal lasts one epoch and one sample is kept, and chain 0's accept
     uniform is 0, so it accepts every finite proposal: the run reaches the
     (0.1, 0.01) switch and the sample write at the flagship shape;
  3. calls each kernel's wrapper at the shapes the main path gave it, holds
     it against its plain version (stated tolerances) and times it, its
     plain version and the closest single PyTorch call with CUDA events
     (K1's from CUDA graphs, device time without the host's launch cost):
     K1 (bf16 on tensor cores, f32 scalar) also at the latent U-Net's shape
     and at edge shapes, and the GroupNorm+SiLU backward K2c in both dtypes
     and both affine forms, each of its two designs (one launch, two-pass),
     also at kernel_check.GN_SHAPES, each case called twice for
     bit-identical results (the checks of nshmc_tpu_torch.scripts.
     kernel_check); nshmc_tpu_torch.scripts.groupnorm_bwd_variants times the
     two designs side by side at every flagship shape (CUDA graphs), each
     time beside the three-pass bound and the five-pass floor, and the
     wrapper's pick beside the faster design;
  4. compares a flagship-width U-Net forward and the pixel loss's input
     gradient through the 3-step decoder (f32, one chain) with the CPU;
  5. runs the port's CLI end to end on configs/ffhq.yaml;
  6. drives the memory-system probe path (nshmc_tpu_torch.scripts.stream_probe)
     at (8, 65536, 128) bf16: holds each probe kernel P1-P4 against its plain
     version, sets their launch counts to 0, times every probe case and reads
     the counts; then runs the GroupNorm microbench
     (nshmc_tpu_torch.scripts.membench2) at (8, 256, 256, 128).
Every phase that fails ends the run with a nonzero exit code. The last lines
are the kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
CHAINS = 8
ATTEMPTS = 3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 non-tensor
PROBE_ITERS = 30     # stream probe: calls per timed case
# Edge shapes of the probe wrappers' range (C a multiple of 8 up to 2048): a
# partial 64-channel block (P4), row layouts that leave threads idle (P1, P2),
# C = 2048; then, for the stats kernels only (P3 needs R % 2048 == 0), row
# counts that end inside a 1,024-row slab and a 128-row tile.
PROBE_EDGE_SHAPES = ((1, 2048, 32), (3, 6144, 96), (2, 4096, 224), (1, 2048, 2048))
STATS_EDGE_SHAPES = ((2, 3000, 8), (1, 100, 72), (3, 1037, 136), (1, 17, 2048))
MEMBENCH_ITERS = 10  # GroupNorm microbench: calls per timed case
MAIN_PATH_KERNELS = ("attention", "gn_stats", "gn_apply")  # P1-P4: probe path only
# K2c's designs (ops/groupnorm.py::bwd_design): on the main path where the
# wrapper picks them at a flagship GN+SiLU shape
BWD_KERNELS = {"one_launch": "gn_backward", "twopass": "gn_backward_twopass"}
# K1 edge shapes (B, T, H, ch), checked in bf16 and f32: ragged query and key tiles
ATTN_EDGE_SHAPES = tuple((2, t, 2, ch) for t in (1, 16, 100, 1000) for ch in (16, 32, 64))
GN_BWD_OPS = 40  # fp32 operations per element of the GN+SiLU backward (~20 for the sums, ~20 for dx)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def gpu_name_and_power():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device ms of fn() over `iters` launches after `warmup`, by CUDA
    events (the probe scripts' timer)."""
    import torch
    from nshmc_tpu_torch.scripts._bench import time_s

    return 1e3 * time_s(fn, torch.device("cuda"), iters, warmup)


def time_ms_graph(fn):
    """Mean device ms of fn() from CUDA graphs of 20 calls, the host's launch
    cost left out (the probe scripts' graph timer)."""
    from nshmc_tpu_torch.scripts._bench import time_s_graph

    return 1e3 * time_s_graph(fn)


def bound_ms(bytes_moved, ops, dtype_name):
    """Least time for the work: the larger of bytes over HBM bandwidth (the
    data sheet's, as the probe scripts use) and operations over the peak
    rate of their type."""
    from nshmc_tpu_torch.scripts._bench import HBM_GB_S

    t_bytes = bytes_moved / (HBM_GB_S * 1e9)
    t_ops = ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def random_state_dict(torch, model, seed):
    """Seeded random weights for every layer. The layers the reference
    zero-initialises (ResBlock and attention output projections, the final
    conv) get small random weights instead, so that every activation and
    gradient the kernels see is live while the network stays near the
    residual identity the reference starts from."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        if p.dim() > 1:
            fan_in = p[0].numel()
            small = (".out_layers.3." in name or ".proj_out." in name
                     or name.startswith("out.2."))
            sd[name] = torch.randn(p.shape, generator=g) * (
                (0.05 if small else 1.0) / math.sqrt(fan_in))
        elif name.endswith("weight"):  # GroupNorm scale
            sd[name] = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
        else:
            sd[name] = 0.05 * torch.randn(p.shape, generator=g)
    return sd


def synthetic_image(np, size, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx + 2 * yy), 0.5 + 0.4 * np.cos(5 * yy),
                    0.5 + 0.3 * np.sin(9 * xx * yy)], -1)
    return np.clip(img + 0.03 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)


def build_kernels(torch, build, gn):
    """nvcc for each CUDA source in a thread, while Triton compiles."""
    reports, errors = {}, []

    def nvcc(src):
        try:
            reports[src] = build.build(src)[1]
        except Exception as e:  # reported after the join, then the run fails
            errors.append(f"{src}: {e}")

    t0 = time.time()
    threads = [threading.Thread(target=nvcc, args=(s,))
               for s in ("attention.cu", "groupnorm_bwd.cu", "stream_probe.cu")]
    for t in threads:
        t.start()
    x = torch.randn(2, 64, 64, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        xs = x.to(dt)
        m, inv = gn.group_combine(gn.channel_stats(xs), 64)
        gn.normalize_silu(xs, m, inv, torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"))
        gn.normalize_silu(xs, m, inv, torch.ones(2, 64, device="cuda"),
                          torch.zeros(2, 64, device="cuda"))
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    check(not errors, "kernel build failed:\n" + "\n".join(errors))
    for src, rep in reports.items():
        for line in build.ptxas_summary(rep):
            print(f"  [{src}] {line}")
    print(f"kernels built in {time.time() - t0:.1f} s (nvcc -gencode arch=compute_90a,"
          f"code=sm_90a; Triton JIT)")


def phase_small_reference(torch, np, mods):
    """Tiny config, f32: pixel loss + input gradient on the card (kernels)
    against the same code on the CPU (plain versions)."""
    import yaml

    with open(os.path.join(ROOT, "configs", "tiny_test.yaml")) as f:
        cfg = yaml.safe_load(f)
    unet, engine, ops_mod, ddim, sched_mod = mods
    mcfg = unet.UNetConfig.from_model_yaml(**cfg["model"])
    model = unet.UNetModel(mcfg)
    model.load_state_dict(random_state_dict(torch, model, SEED + 1))
    d = mcfg.image_size
    x_orig = torch.from_numpy(2 * synthetic_image(np, d, SEED) - 1)[None]
    x = torch.randn((2, d, d, 3), generator=torch.Generator().manual_seed(SEED))
    results = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        op = ops_mod.build_operator("inpaint_random", 3, d, np.random.default_rng(SEED),
                                    device=dev)
        decode = ddim.make_decoder(m, sched_mod.DiffusionSchedule.create(device=dev),
                                   sched_mod.DDIMSequence.create(1000, 3))
        y0 = op.H_img(x_orig.to(dev))[0]
        loss_fn = engine.make_pixel_loss_fn(decode, op, y0)
        loss, dec, grad = engine.value_and_grad(loss_fn, x.to(dev))
        results[dev] = [t.detach().cpu() for t in (loss, dec, grad)]
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(results["cuda"], results["cpu"])]
    print(f"small reference (tiny U-Net, f32, card vs CPU): relative L2 error "
          f"loss {rel[0]:.2e}, decoded {rel[1]:.2e}, gradient {rel[2]:.2e} (tolerance 2e-4)")
    check(max(rel) < 2e-4, f"card disagrees with the CPU on the small input: {rel}")


def trace_eval(torch, engine, loss_fn, x, out_dir):
    """`chip_smoke.py --trace OUT_DIR`: profile one flagship energy+grad
    evaluation (after one untimed) with torch.profiler; print the kernels by
    device time and the busy share of the device, and write a Chrome trace
    to OUT_DIR/trace_main_path.json."""
    from torch.profiler import ProfilerActivity, profile

    engine.value_and_grad(loss_fn, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.value_and_grad(loss_fn, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)
    # the kernels' own rows: the operator rows repeat their kernels' time
    busy_us = sum(dev_time(e) for e in events if e.device_type == DeviceType.CUDA)
    print(f"trace: one energy+grad eval, {CHAINS} chains: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of wall)")
    print(events.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=70))
    print(events.table(sort_by="self_cpu_time_total", row_limit=25, max_name_column_width=70))
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace_main_path.json"))


def phase_probes(torch, shape):
    """Phase 6: the memory-system probe path at `shape` (B, R, C) bf16 and
    the GroupNorm microbench. Returns {kernel: record} for P1-P4, with the
    launches counted over the probe's timed cases."""
    from nshmc_tpu_torch.ops import groupnorm as gn
    from nshmc_tpu_torch.ops import stream_probe as sp
    from nshmc_tpu_torch.scripts import membench2, stream_probe

    t0 = time.time()
    x, scale, bias = stream_probe.make_inputs(shape)
    checks = stream_probe.check_kernels(x, scale, bias)
    for name, res in checks.items():
        print(f"probe check {name} {shape} bf16: max|kernel-plain| {res['max_abs_err']:.3e} "
              f"(tol {res['tolerance']}): {'ok' if res['ok'] else 'DISAGREES'}")
    check(all(r["ok"] for r in checks.values()), f"probe kernels disagree: {checks}")
    for edge in PROBE_EDGE_SHAPES:
        res = stream_probe.check_kernels(*stream_probe.make_inputs(edge))
        check(all(v["ok"] for v in res.values()), f"probe kernels disagree at {edge}: {res}")
    for edge in STATS_EDGE_SHAPES:
        x_e = stream_probe.make_inputs(edge)[0]
        for fn in (sp.probe_stats, sp.probe_mma_stats):
            err, ok = stream_probe.stats_check(fn(x_e), gn.channel_stats_plain(x_e))
            check(ok, f"{fn.__name__} disagrees at {edge}: max|d| {err}")
    print(f"probe kernels agree at the edge shapes {PROBE_EDGE_SHAPES} and, P1 and P4, "
          f"{STATS_EDGE_SHAPES}")

    for f in sp.KERNELS:
        f.launches = 0
    timed = stream_probe.time_cases(x, scale, bias, PROBE_ITERS)
    launches = {f.__name__: f.launches for f in sp.KERNELS}
    for name, res in timed.items():
        print(f"probe case {json.dumps({'case': name, **res})}")
    print(f"probe path kernel launches ({PROBE_ITERS} timed calls + warm-up per case): "
          f"{launches}")
    for k, v in launches.items():
        check(v > 0, f"probe kernel {k} was never launched on the probe path")

    b, r, c = shape
    n = b * r * c
    ms = lambda case: 1e3 * timed[case]["s_per_iter"]
    touch_plain = time_ms(lambda: sp.touch_plain(x))
    stats_bytes = n * 2 + b * 2 * c * 4
    rows = {  # kernel: (case, plain ms, library ms, bytes, operations, their type)
        "probe_stats": ("cuda_stats", ms("torch_stats"), None, stats_bytes, 3 * n, "float32"),
        "probe_apply": ("cuda_apply", ms("torch_apply"), None,
                        2 * n * 2 + (2 * b * c + 2 * c) * 4, 8 * n, "float32"),
        "probe_touch": ("cuda_dma_read", touch_plain, None, n * 2 + b * c * 4, 0, "float32"),
        # three m16n8k16 products (x, hi, lo) per 16 rows x 8 channels
        "probe_mma_stats": ("cuda_mma_stats", ms("torch_stats"), ms("torch_matmul_stats"),
                            stats_bytes, 96 * n, "bfloat16"),
    }
    records = {}
    for name, (case, plain, lib, nbytes, ops, dtype) in rows.items():
        bms, by = bound_ms(nbytes, ops, dtype)
        records[name] = dict(ms=ms(case), plain_ms=plain, library_ms=lib, bound_ms=bms,
                             bound_by=by, max_abs_err=checks[name]["max_abs_err"],
                             tolerance=checks[name]["tolerance"], shape=list(shape),
                             dtype="bfloat16", launches=launches[name])
        print(f"{name} {shape} bf16: kernel {records[name]['ms']:.4f} ms, plain {plain:.4f} ms, "
              f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms ({by})")

    bench = membench2.main([str(b), str(math.isqrt(r)), str(c), str(MEMBENCH_ITERS)])
    check(all(v["s_per_iter"] for v in bench["cases"].values()),
          "GroupNorm microbench left a case untimed")
    print(f"phase 6 (stream probe + GroupNorm microbench) took {time.time() - t0:.1f} s")
    return records


def main():
    args = sys.argv[1:]
    trace_dir = None
    if args[:1] == ["--trace"] and len(args) == 2:
        trace_dir = args[1]
    elif args:
        fail("usage: chip_smoke.py [--trace OUT_DIR]")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import yaml
        from nshmc_tpu_torch.hmc import engine
        from nshmc_tpu_torch.models import unet
        from nshmc_tpu_torch.operators import build_operator
        from nshmc_tpu_torch.ops import _build as build
        from nshmc_tpu_torch.ops import attention as attn
        from nshmc_tpu_torch.ops import groupnorm as gn
        from nshmc_tpu_torch.ops import stream_probe as sp
        from nshmc_tpu_torch.sampling import ddim
        from nshmc_tpu_torch.scripts import kernel_check as kc
        from nshmc_tpu_torch import operators as ops_mod
        from nshmc_tpu_torch import schedules as sched_mod
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout of the repository): {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions: f32 phases run in full f32")
    card = gpu_name_and_power()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda")

    # ---- build -------------------------------------------------------------
    build_kernels(torch, build, gn)

    # ---- 1. small input against the CPU --------------------------------------
    phase_small_reference(torch, np, (unet, engine, ops_mod, ddim, sched_mod))

    # ---- 2. the main path ------------------------------------------------------
    with open(os.path.join(ROOT, "configs", "ffhq.yaml")) as f:
        cfg = yaml.safe_load(f)
    mcfg = unet.UNetConfig.from_model_yaml(**cfg["model"])
    d, c = cfg["data"]["image_size"], cfg["data"]["channels"]
    model = unet.UNetModel(mcfg, dtype=torch.bfloat16)
    weights = random_state_dict(torch, model, SEED)
    model.load_state_dict(weights)
    model = model.to(dev).eval()
    sched = sched_mod.DiffusionSchedule.create(
        cfg["diffusion"]["beta_schedule"], cfg["diffusion"]["beta_start"],
        cfg["diffusion"]["beta_end"], cfg["diffusion"]["num_diffusion_timesteps"], device=dev)
    seq = sched_mod.DDIMSequence.create(1000, 3)
    decode = ddim.make_decoder(model, sched, seq)
    op = build_operator("inpaint_random", c, d, np.random.default_rng(SEED), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x_orig = 2 * torch.from_numpy(synthetic_image(np, d, SEED)).to(dev)[None] - 1
    sigma_0 = 2 * 0.05
    y0 = op.H_img(x_orig)
    y0 = y0 + sigma_0 * torch.randn(y0.shape, generator=gen, device=dev)
    hcfg = engine.HMCConfig(sigma_0=sigma_0, tau=1.0, epsilon=0.05, epochs=1, sampling=1,
                            max_attempts=ATTEMPTS)
    loss_fn = engine.make_pixel_loss_fn(decode, op, y0[0])
    state = engine.init_chains(hcfg, CHAINS, (d, d, c), dev, gen)

    # one no-grad forward at the main path's batch records the shapes each
    # kernel sees (GroupNorm+SiLU sites and attention blocks)
    gn_sites, attn_sites = {}, {}

    def gn_hook(mod, args, out):
        xx = args[0]
        key = (xx.shape[0], xx.shape[2] * xx.shape[3], xx.shape[1], len(args) > 1)
        gn_sites[key] = gn_sites.get(key, 0) + 1

    def attn_hook(mod, args, out):
        xx = args[0]
        key = (xx.shape[0], xx.shape[2] * xx.shape[3], mod.heads, xx.shape[1] // mod.heads)
        attn_sites[key] = attn_sites.get(key, 0) + 1

    from nshmc_tpu_torch.models.nn import GroupNormSiLU
    hooks = [m.register_forward_hook(gn_hook) for m in model.modules()
             if isinstance(m, GroupNormSiLU)]
    hooks += [m.register_forward_hook(attn_hook) for m in model.modules()
              if isinstance(m, unet.AttentionBlock)]
    with torch.no_grad():
        warm = model(state.x, torch.full((CHAINS,), 750.0, device=dev))
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    check(torch.isfinite(warm).all().item() and warm.shape == (CHAINS, d, d, 6),
          "flagship U-Net forward is not finite / has the wrong shape")
    n_gn, n_attn = sum(gn_sites.values()), sum(attn_sites.values())
    print(f"flagship U-Net forward: {n_gn} GroupNorm+SiLU sites over {len(gn_sites)} shapes, "
          f"{n_attn} attention blocks over {len(attn_sites)} shapes")

    if trace_dir is not None:
        trace_eval(torch, engine, loss_fn, state.x, trace_dir)
        return

    # the main path's kernels, and the probe kernels, which it must not run
    gn_shapes = {}  # (B, rows, C) -> GN+SiLU sites per U-Net forward, both forms
    for (b, r, cc, _), n_sites in gn_sites.items():
        gn_shapes[(b, r, cc)] = gn_shapes.get((b, r, cc), 0) + n_sites
    check(gn_shapes == kc.FLAGSHIP_GN_SITES,
          f"GN+SiLU sites {gn_shapes} are not kernel_check.FLAGSHIP_GN_SITES")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    on_path = set(MAIN_PATH_KERNELS) | {BWD_KERNELS[gn.bwd_design(*shape, 2, sms)]
                                        for shape in kc.FLAGSHIP_GN_SITES}
    counters = {"attention": attn.attention_forward, "gn_stats": gn.channel_stats,
                "gn_apply": gn.normalize_silu, "gn_backward": gn.launch_one,
                "gn_backward_twopass": gn.launch_twopass,
                **{f.__name__: f for f in sp.KERNELS}}
    for f in (*counters.values(), gn.groupnorm_silu_backward):
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    round_s = []

    def timed(states, rnd):
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())

    def draws():  # the engine's own draws, but chain 0 accepts every finite proposal
        for _ in range(ATTEMPTS):
            p0 = torch.randn(state.x.shape, generator=gen, device=dev) * math.sqrt(hcfg.m)
            u = torch.rand((CHAINS,), generator=gen, device=dev)
            u[0] = 0.0
            yield p0, u

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.run_hmc(loss_fn, hcfg, state, gen, draws=draws(), callback=timed)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    bwd_calls = gn.groupnorm_silu_backward.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    evals = hcfg.n_leapfrog + 1
    steps = [b - a for a, b in zip([t0] + round_s[:-1], round_s)]
    steady = steps[1:] or steps
    evals_per_s = evals * len(steady) / sum(steady)
    print(f"main path: {len(steps)} MH attempts x {evals} energy+grad evals, {CHAINS} chains, "
          f"bf16; attempt times {[round(s, 3) for s in steps]} s; "
          f"{evals_per_s:.3f} energy+grad evals/s (attempts 2+); peak memory {peak_gb:.2f} GB")
    print(f"main path kernel launches: {launches} "
          f"(per energy+grad eval: "
          f"{ {k: v / (evals * len(steps)) for k, v in launches.items()} })")
    print(f"GN+SiLU backward calls per U-Net forward: {bwd_calls / (3 * evals * len(steps)):.2f} "
          f"(expected one per GN+SiLU site: {n_gn}), one kernel design each: "
          f"{launches['gn_backward']} one-launch + {launches['gn_backward_twopass']} two-pass")
    check(bwd_calls == 3 * evals * len(steps) * n_gn
          and bwd_calls == launches["gn_backward"] + launches["gn_backward_twopass"],
          f"{bwd_calls} GN+SiLU backward calls for {n_gn} sites: {launches}")
    for k, v in launches.items():
        if k in on_path:
            check(v > 0, f"kernel {k} was never launched on the main path")
        else:
            check(v == 0, f"kernel {k} was launched {v} times on the main path, where no "
                          f"shape takes it")
    check(bool(torch.isfinite(out.x).all()), "chain state is not finite")
    check(int(out.attempts.min()) == ATTEMPTS, f"attempts {out.attempts.tolist()}")
    check(float(out.last_decoded.abs().max()) <= 1.0, "decoded images leave [-1, 1]")
    print(f"main path state: accepted {out.accepted.tolist()}, epoch {out.epoch.tolist()}, "
          f"tau {[round(v, 4) for v in out.tau.tolist()]}, "
          f"last loss {[round(v, 1) for v in out.last_loss.tolist()]}")
    # chain 0: accepted at epochs 0 (anneal), 1 (after the switch) and 2 (the
    # sample slot), so its one sample is the decoded image of its last proposal
    check(int(out.accepted[0]) == ATTEMPTS and int(out.epoch[0]) == hcfg.total_epochs,
          f"chain 0 did not accept every proposal: accepted {out.accepted.tolist()}")
    check(abs(float(out.tau[0]) - hcfg.post_tau) < 1e-6
          and abs(float(out.epsilon[0]) - hcfg.post_epsilon) < 1e-6,
          f"chain 0 did not switch to (post_tau, post_epsilon): {out.tau[0]}, {out.epsilon[0]}")
    written = out.samples.flatten(1).abs().amax(dim=1) > 0
    check(written.tolist() == (out.epoch == hcfg.total_epochs).tolist(),
          f"samples written {written.tolist()} for epochs {out.epoch.tolist()}")
    check(torch.equal(out.samples[0, 0], out.last_decoded[0]),
          "chain 0's sample is not the decoded image of its last accepted proposal")
    print(f"main path sample write: chains {written.nonzero().flatten().tolist()} wrote their "
          f"sample (chain 0: anneal -> switch to ({hcfg.post_tau}, {hcfg.post_epsilon}) -> "
          f"sample, equal to its last decoded image)")

    # ---- 3. each kernel against its plain version, at the main path's shapes --
    records = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rec(name, **kw):
        records.setdefault(name, {}).update(kw)

    attn_shapes = sorted(attn_sites) + [(CHAINS, 1024, 8, 32)]  # + the latent U-Net's
    for (b, t, h, ch) in attn_shapes:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = kc.qkv_inputs((b, t, h, ch), dt, g, dev)
            res = kc.attention_check(q, k, v)
            # gradient through the autograd.Function vs autograd of the plain version
            qs = [x.detach().float().to(dt).requires_grad_(True) for x in (q, k, v)]
            gk = torch.autograd.grad((attn.attention(*qs).float() ** 2).sum(), qs)
            gp = torch.autograd.grad((attn.attention_plain(*qs).float() ** 2).sum(), qs)
            gerr = max(float((a.float() - b_.float()).norm() / b_.float().norm())
                       for a, b_ in zip(gk, gp))
            gtol = 1e-4 if dt == torch.float32 else 3e-2
            dname = str(dt).split(".")[1]
            # device ms per call from CUDA graphs of 20 calls (the host's
            # launch cost left out: at these sizes it exceeds the kernels'),
            # and the kernel's eager ms per call, host included
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = time_ms_graph(lambda: attn.attention_forward(q, k, v))
            plain = time_ms_graph(lambda: attn.attention_plain(q, k, v))
            lib = time_ms_graph(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, scale=1.0 / math.sqrt(ch)))
            eager = time_ms(lambda: attn.attention_forward(q, k, v))
            nbytes = 4 * b * t * h * ch * q.element_size()
            bms, by = bound_ms(nbytes, 4 * b * h * t * t * ch, dname)
            print(f"K1 attention {(b, t, h, ch)} {dname}: {kc.attention_summary(res)}; grad rel "
                  f"err {gerr:.2e} (tol {gtol}); device ms per call: kernel {ms:.4f}, plain "
                  f"{plain:.4f}, sdpa {lib:.4f} (kernel/sdpa {ms / lib:.2f}), bound {bms:.4f} "
                  f"({by}); eager kernel call {eager:.4f} ms")
            check(res["ok"] and gerr <= gtol, f"attention {(b, t, h, ch)} {dname} disagrees")
            if (b, t, h, ch, dt) == (CHAINS, 256, 8, 64, torch.bfloat16):
                rec("attention", ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                    bound_by=by, max_abs_err=res["max_abs_err"], tolerance=res["tolerance"],
                    shape=[b, t, h, ch], dtype=dname)
    edge = {}
    for shape in ATTN_EDGE_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            res = kc.attention_check(*kc.qkv_inputs(shape, dt, g, dev))
            check(res["ok"], f"attention {shape} {dt}: {kc.attention_summary(res)}")
            worst_ = edge.setdefault(dt, res)
            if res["max_abs_err"] > worst_["max_abs_err"]:
                edge[dt] = res
    print(f"K1 agrees at the edge shapes (2, T, 2, ch), T in (1, 16, 100, 1000), ch in "
          f"(16, 32, 64); worst bf16: {kc.attention_summary(edge[torch.bfloat16])}; worst "
          f"f32: {kc.attention_summary(edge[torch.float32])}")

    worst = {}  # (kernel, dtype) -> max abs err over the shapes and forms
    for (b, r, cc) in sorted(gn_shapes):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            x = (1.5 * torch.randn((b, r, cc), generator=g, device=dev) + 0.3).to(dt)
            st_k, st_p = gn.channel_stats(x), gn.channel_stats_plain(x)
            st_abs = float((st_k - st_p).abs().max())
            st_rel = st_abs / float(st_p.abs().max())  # fp32 sums of r values
            mean_c, inv_c = gn.group_combine(st_p, r)
            for form in ("per_channel", "per_batch_channel"):
                shape = (cc,) if form == "per_channel" else (b, cc)
                sc = 1 + 0.3 * torch.randn(shape, generator=g, device=dev)
                bi = 0.3 * torch.randn(shape, generator=g, device=dev)
                y_k = gn.normalize_silu(x, mean_c, inv_c, sc, bi)
                y_p = gn.normalize_silu_plain(x, mean_c, inv_c, sc, bi)
                diff = (y_k.float() - y_p.float()).abs()
                if dt == torch.float32:
                    ok = bool((diff <= 1e-4).all())
                else:  # one bf16 rounding step apart: |d| <= 2^-7 |y| + 1e-3
                    ok = bool((diff <= 2 ** -7 * y_p.float().abs() + 1e-3).all())
                check(ok and st_rel <= 1e-5,
                      f"GroupNorm+SiLU {(b, r, cc)} {dname} {form}: stats rel {st_rel:.2e}, "
                      f"apply max {float(diff.max()):.2e}")
                key = ("gn_apply", dname, (b, r, cc))
                worst[key] = max(worst.get(key, 0.0), float(diff.max()))
            worst[("gn_stats", dname, (b, r, cc))] = st_abs
            worst[("gn_stats_rel", dname, (b, r, cc))] = st_rel
    top = lambda kern, dname: max(v for k, v in worst.items() if k[:2] == (kern, dname))
    print(f"K2 GroupNorm+SiLU: {len(gn_shapes)} main-path shapes x (bf16, f32) x (per-channel, "
          f"per-(batch, channel) affine) agree: stats worst rel err bf16 "
          f"{top('gn_stats_rel', 'bfloat16'):.2e}, f32 {top('gn_stats_rel', 'float32'):.2e} "
          f"(tol 1e-5); apply worst abs err f32 {top('gn_apply', 'float32'):.2e} (tol 1e-4), "
          f"bf16 {top('gn_apply', 'bfloat16'):.2e} (tol 2^-7 |y| + 1e-3)")

    for (b, r, cc), n_sites in sorted(gn_shapes.items()):  # times at each shape, bf16
        x = (1.5 * torch.randn((b, r, cc), generator=g, device=dev) + 0.3).to(torch.bfloat16)
        sc = 1 + 0.3 * torch.randn((b, cc), generator=g, device=dev)
        bi = 0.3 * torch.randn((b, cc), generator=g, device=dev)
        mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r)
        st_ms = time_ms(lambda: gn.channel_stats(x))
        st_plain = time_ms(lambda: gn.channel_stats_plain(x))
        ap_ms = time_ms(lambda: gn.normalize_silu(x, mean_c, inv_c, sc, bi))
        ap_plain = time_ms(lambda: gn.normalize_silu_plain(x, mean_c, inv_c, sc, bi))
        whole = time_ms(lambda: gn.groupnorm_silu(x, sc, bi))
        x4 = x.reshape(b, int(math.isqrt(r)), -1, cc).permute(0, 3, 1, 2)  # NCHW channels_last
        w1, b1 = sc[0].to(x.dtype), bi[0].to(x.dtype)
        lib = time_ms(lambda: torch.nn.functional.silu(
            torch.nn.functional.group_norm(x4, 32, w1, b1, 1e-5)))
        n = b * r * cc
        st_b, st_by = bound_ms(n * 2 + b * 2 * cc * 4, 3 * n, "float32")
        ap_b, ap_by = bound_ms(2 * n * 2 + 4 * b * cc * 4, 8 * n, "float32")
        print(f"K2 {(b, r, cc)} bf16, {n_sites} sites/forward: stats {st_ms:.4f} ms "
              f"(plain {st_plain:.4f}, bound {st_b:.4f}), apply {ap_ms:.4f} ms (plain "
              f"{ap_plain:.4f}, bound {ap_b:.4f}); whole GN+SiLU {whole:.4f} ms vs "
              f"F.group_norm+F.silu {lib:.4f} ms")
        if (b, r, cc) == (CHAINS, d * d, mcfg.model_channels):
            common = dict(shape=[b, r, cc], dtype="bfloat16", library_ms=None)
            rec("gn_stats", ms=st_ms, plain_ms=st_plain, bound_ms=st_b, bound_by=st_by,
                max_abs_err=worst[("gn_stats", "bfloat16", (b, r, cc))],
                tolerance="1e-5 x max|sum|", **common)
            rec("gn_apply", ms=ap_ms, plain_ms=ap_plain, bound_ms=ap_b, bound_by=ap_by,
                max_abs_err=worst[("gn_apply", "bfloat16", (b, r, cc))],
                tolerance="2^-7 |y| + 1e-3", **common)
            print(f"K2 whole GN+SiLU at {(b, r, cc)} bf16: {whole:.4f} ms, "
                  f"F.group_norm+F.silu {lib:.4f} ms")

    bwd_worst, bwd_hot = {}, {}  # dtype -> (max dx err, max affine rel err); design -> result
    for shape in dict.fromkeys([*sorted(gn_shapes), *kc.GN_SHAPES]):  # K2c's designs vs plain
        for dt in (torch.bfloat16, torch.float32):
            for form in kc.AFFINE_FORMS:
                inputs = kc.gn_inputs(shape, dt, form, g, dev)
                for design in BWD_KERNELS:
                    res = kc.gn_backward_check(*inputs, design=design)
                    check(res["ok"], f"GN+SiLU backward {design} {shape} {dt} {form}: {res}")
                    if shape not in gn_shapes:  # edge shapes of the wrapper's range
                        continue
                    dx_w, af_w = bwd_worst.get(dt, (0.0, 0.0))
                    bwd_worst[dt] = (max(dx_w, res["dx_err"]), max(af_w, res["affine_rel_err"]))
                    if (shape, dt, form) == ((CHAINS, d * d, mcfg.model_channels),
                                             torch.bfloat16, "per_batch_channel"):
                        bwd_hot[design] = res
    print(f"K2c GN+SiLU backward, both designs: {len(gn_shapes)} main-path shapes and "
          f"{len(kc.GN_SHAPES)} edge shapes x (bf16, f32) x (per-channel, per-(batch, channel) "
          f"affine) agree, two calls bit-identical in every case: worst main-path dx err bf16 "
          f"{bwd_worst[torch.bfloat16][0]:.2e} (tol 2^-7 |dx| + 2^-12 max|dx|), f32 "
          f"{bwd_worst[torch.float32][0]:.2e} (tol 1e-4); dscale/dbias worst rel err "
          f"{max(v[1] for v in bwd_worst.values()):.2e} (tol 1e-5)")
    # the two designs side by side at every flagship shape, in this call
    from nshmc_tpu_torch.scripts import groupnorm_bwd_variants
    variants = groupnorm_bwd_variants.main([])
    check(all(v["agrees"] for v in variants), "a K2c design disagrees with the plain version")
    print(f"K2c designs: {json.dumps(groupnorm_bwd_variants.summary(variants))}")
    variants = {(tuple(v["shape"]), v["dtype"]): v for v in variants}
    for (b, r, cc), n_sites in sorted(gn_shapes.items()):  # K2c times at each shape, bf16
        v = variants[((b, r, cc), "bfloat16")]
        x, gk, mean_c, inv_c, sc, bi = kc.gn_inputs((b, r, cc), torch.bfloat16,
                                                    "per_batch_channel", g, dev)
        bw_plain = time_ms(lambda: gn.groupnorm_silu_backward_plain(x, gk, mean_c, inv_c, sc, bi))
        # yardstick: the backward of F.group_norm + F.silu alone, a per-channel
        # affine and two library backwards: not the same function
        side = math.isqrt(r)
        x4 = x.reshape(b, side, side, cc).permute(0, 3, 1, 2).detach().requires_grad_(True)
        y4 = torch.nn.functional.silu(torch.nn.functional.group_norm(
            x4, 32, sc[0].to(x.dtype), bi[0].to(x.dtype), 1e-5))
        g4 = gk.reshape(b, side, side, cc).permute(0, 3, 1, 2)
        bw_lib = time_ms(lambda: torch.autograd.grad(y4, x4, g4, retain_graph=True))
        n = b * r * cc
        small = (2 * b * cc + 2 * b * cc + b * cc * 2) * 4  # stats, affine in; its grads out
        bw_b, bw_by = bound_ms(3 * n * 2 + small, GN_BWD_OPS * n, "float32")
        floor5 = bound_ms(5 * n * 2, 0, "float32")[0]  # a design that reads x and g twice
        best = min(v["one_launch_ms"], v["twopass_ms"])
        print(f"K2c {(b, r, cc)} bf16, {n_sites} sites/forward: one launch "
              f"{v['one_launch_ms']:.4f} ms, two-pass {v['twopass_ms']:.4f} ({v['timing']}); "
              f"the wrapper picks {v['picked']}, the faster is {v['faster']}; plain "
              f"{bw_plain:.4f}, three-pass bound {bw_b:.4f} ({bw_by}), five-pass floor "
              f"{floor5:.4f}: the faster design {'under' if best < floor5 else 'NOT under'} "
              f"it; F.group_norm+F.silu backward {bw_lib:.4f} ms")
        if (b, r, cc) == (CHAINS, d * d, mcfg.model_channels):
            for design, name in BWD_KERNELS.items():
                res = bwd_hot[design]
                rec(name, ms=v[f"{design}_ms"], plain_ms=bw_plain, library_ms=bw_lib,
                    bound_ms=bw_b, bound_by=bw_by, max_abs_err=res["dx_err"],
                    tolerance=res["tolerance"], shape=[b, r, cc], dtype="bfloat16",
                    five_pass_floor_ms=floor5, timing=v["timing"],
                    picked_at_this_shape=v["picked"] == design)
        del x4, y4

    # ---- 4. flagship width, f32, one chain: card vs CPU ------------------------
    # a U-Net forward, then the pixel loss and its input gradient through the
    # 3-step decoder (three U-Nets and their backward, remat included)
    model32 = unet.UNetModel(mcfg).eval()
    model32.load_state_dict(weights)
    x1, t1 = state.x[:1].cpu(), torch.full((1,), 500.0)
    y0_1 = y0[0].cpu()
    results = {}
    for where in ("cpu", "cuda"):
        model32 = model32.to(where)
        with torch.no_grad():
            fwd = model32(x1.to(where), t1.to(where))
        op_w = build_operator("inpaint_random", c, d, np.random.default_rng(SEED), device=where)
        decode_w = ddim.make_decoder(model32, sched_mod.DiffusionSchedule.create(
            cfg["diffusion"]["beta_schedule"], cfg["diffusion"]["beta_start"],
            cfg["diffusion"]["beta_end"], cfg["diffusion"]["num_diffusion_timesteps"],
            device=where), seq)
        loss_w = engine.make_pixel_loss_fn(decode_w, op_w, y0_1.to(where))
        loss1, dec1, grad1 = engine.value_and_grad(loss_w, x1.to(where))
        results[where] = [v.detach().cpu() for v in (fwd, loss1, dec1, grad1)]
    rel = [float((a_ - b_).norm() / b_.norm()) for a_, b_ in zip(results["cuda"], results["cpu"])]
    print(f"flagship width, f32, one chain, card vs CPU: relative L2 error U-Net forward "
          f"{rel[0]:.2e}, loss {rel[1]:.2e}, decoded {rel[2]:.2e}, input gradient {rel[3]:.2e} "
          f"(tolerance 1e-4 forward, 2e-4 the rest; gradient nonzero at "
          f"{int((results['cpu'][3] != 0).sum())} of {results['cpu'][3].numel()} entries)")
    check(rel[0] < 1e-4 and max(rel[1:]) < 2e-4 and float(results["cpu"][3].abs().max()) > 0,
          f"flagship f32 forward or gradient disagrees with the CPU: {rel}")
    del model32, model, out, state

    # ---- 5. the port's CLI end to end ---------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        from PIL import Image

        Image.fromarray((synthetic_image(np, d, SEED + 3) * 255).astype(np.uint8)).save(
            os.path.join(data, "face.png"))
        cmd = [sys.executable, "-m", "nshmc_tpu_torch.cli", "--config",
               os.path.join(ROOT, "configs", "ffhq.yaml"), "--device", "cuda",
               "--algo", "hmc", "--deg", "inpaint_random", "--chains", "2", "--tau", "0.1",
               "--epsilon", "0.05", "--hmc_epochs", "1", "--hmc_sampling", "1",
               "--data_path", data, "-i", os.path.join(tmp, "out")]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        check(r.returncode == 0 and lines and lines[-1].startswith('{"summary"'),
              f"CLI failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        summary = json.loads(lines[-1])["summary"]
        check(math.isfinite(summary.get("psnr", float("nan"))), f"CLI summary {summary}")
        for f in ("0.png", "orig_0.png", "y0_0.png", "std_dev_map_0.png", "metrics.jsonl"):
            check(os.path.exists(os.path.join(tmp, "out", f)), f"CLI did not write {f}")
        print(f"CLI (configs/ffhq.yaml, 2 chains, cuda) in {time.time() - t0:.1f} s: "
              f"{lines[-1]}")

    # ---- 6. the memory-system probes, off the sampling path ---------------------------
    for name, rec_ in phase_probes(torch, (CHAINS, d * d, mcfg.model_channels)).items():
        rec(name, **rec_)

    probe_src = "nshmc_tpu_torch/csrc/stream_probe.cu"
    sources = {"attention": ("cuda", "nshmc_tpu_torch/csrc/attention.cu",
                             "nshmc_tpu/ops/attention.py:44"),
               "gn_stats": ("triton", "nshmc_tpu_torch/ops/groupnorm.py",
                            "nshmc_tpu/ops/groupnorm.py:55"),
               "gn_apply": ("triton", "nshmc_tpu_torch/ops/groupnorm.py",
                            "nshmc_tpu/ops/groupnorm.py:75"),
               "gn_backward": ("cuda", "nshmc_tpu_torch/csrc/groupnorm_bwd.cu",
                               "nshmc_tpu/ops/groupnorm.py:150 _gn_bwd"),
               "gn_backward_twopass": ("cuda", "nshmc_tpu_torch/csrc/groupnorm_bwd.cu",
                                       "nshmc_tpu/ops/groupnorm.py:150 _gn_bwd"),
               "probe_stats": ("cuda", probe_src, "scripts/pallas_stream_probe.py:43"),
               "probe_apply": ("cuda", probe_src, "scripts/pallas_stream_probe.py:73"),
               "probe_touch": ("cuda", probe_src, "scripts/pallas_stream_probe.py:183"),
               "probe_mma_stats": ("cuda", probe_src, "scripts/pallas_stream_probe.py:198")}
    kernels = []
    for name, (route, src, replaces) in sources.items():
        r_ = records[name]
        on_main = name in MAIN_PATH_KERNELS or name in BWD_KERNELS.values()
        # `launches`: the count of the kernel's own path (the flagship HMC run,
        # or the probe's timed cases for P1-P4), each set to 0 just before it;
        # `main_path_launches`: every kernel's count over the flagship HMC run
        kernels.append({"name": name, "route": route, "source": src, "replaces": replaces,
                        "launches": launches[name] if on_main else r_["launches"],
                        "path": "flagship HMC" if on_main else "stream probe",
                        "main_path_launches": launches[name],
                        "max_abs_err": r_["max_abs_err"],
                        "ms": r_["ms"], "plain_ms": r_["plain_ms"], "bound_ms": r_["bound_ms"],
                        "bound_by": r_["bound_by"], "library_ms": r_["library_ms"],
                        "shape": r_["shape"], "dtype": r_["dtype"],
                        "tolerance": r_["tolerance"],
                        **{k: r_[k] for k in ("five_pass_floor_ms", "timing",
                                              "picked_at_this_shape") if k in r_}})
    print(json.dumps({"kernels": kernels, "main_path": {
        "energy_grad_evals_per_s": evals_per_s, "peak_memory_gb": peak_gb,
        "chains": CHAINS, "attempts": ATTEMPTS, "n_leapfrog": hcfg.n_leapfrog}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
