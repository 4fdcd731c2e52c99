#!/usr/bin/env python3
"""Chip smoke run of nshmc_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --trace OUT_DIR  # profile one flagship and two latent evaluations

It builds the port's kernels from the sources in this checkout and then:
  1. holds the port's output against its plain-PyTorch path on the CPU on a
     small input (the tiny config's pixel loss and gradient, f32);
  2. drives the main path: the flagship pixel noise-space HMC through the
     port's engine — ADM U-Net at 256^2 (configs/ffhq.yaml, random weights
     from a seed), 3-step DDIM, 92% random inpainting, tau 1.0 / eps 0.05
     (L = 20), 8 chains as the batch, bf16 — for a few MH attempts, with every
     kernel's launch count set to 0 just before and read just after (K1's
     f32 kernel: none; K2a once for each GN+SiLU and GroupNorm32 call that
     forward hooks count during the run, K2b once for each GN+SiLU call;
     K2a's plain versions never, counted by wrappers). The
     anneal lasts one epoch and one sample is kept, and chain 0's accept
     uniform is 0, so it accepts every finite proposal: the run reaches the
     (0.1, 0.01) switch and the sample write at the flagship shape;
  3. calls each kernel's wrapper at the shapes the main path gave it, holds
     it against its plain version (stated tolerances) and times it, its
     plain version and the closest single PyTorch call with CUDA events
     (K1's from CUDA graphs, device time without the host's launch cost):
     K1 (bf16 on tensor cores; f32 on tensor cores in 3xTF32, its bound at
     495 / 3 TFLOP/s) also at edge shapes; K2a's one launch (sums, mean_c,
     inv_c) at every GN+SiLU and GroupNorm32 shape and GN_SHAPES in both
     dtypes, two calls bit-identical, and the eps 1e-6 variance clip;
     nshmc_tpu_torch.scripts.groupnorm_stats_variants times it beside the
     Triton chain it replaced, P1's chain and torch.var_mean at every K2a
     site of the three paths (CUDA graphs and eager); K2b on plain
     statistics; and the GroupNorm+SiLU backward K2c in both dtypes
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
     (nshmc_tpu_torch.scripts.membench2) at (8, 256, 256, 128);
  7. the latent path: (a) the tiny latent config's latent loss, z0 and
     z-gradient, f32, card vs CPU (the quantizer's differing-code share
     reported and bounded); (b) the latent flagship (configs/ffhq_latent.yaml
     at full width, random weights, 92% random inpainting at 256^2, 3-step
     DDIM, 8 chains, MH attempts at L = 20, y0's noise and z_T drawn on the
     host as the CLI draws them) through the port's latent engine, in bf16
     (3 attempts) and then in f32, the CLI's type (2 attempts, cuDNN
     convolutions in TF32 as torch's defaults and so the CLI have them), each
     with every kernel count set to 0 just before and read just after: K1 at
     all 16 attention blocks of each eps-net forward (the bf16 run through
     its bf16 kernel only, the f32 run through the 3xTF32 kernel only, each
     kernel counted on its own), K2a at every GN+SiLU and GroupNorm32 site,
     K2b at every GN+SiLU site, K2c at the VQ decoder's 23 and at none of
     the stop-gradded eps-net's, P1-P4 and K2a's plain versions never; evals/s, peak
     memory and useful TFLOP/s; (c) K1 at the latent U-Net's three shapes,
     bf16 and f32, timed beside SDPA and the bound; (d) K2a/K2b/K2c at the
     VQ decoder's sites, eps 1e-6 (K2a/K2b also at the U-Net's, K2a at the
     GroupNorm32 sites), K2b and K2c timed in bf16 and f32, K2c beside the
     F.group_norm + F.silu backward; (e) the
     CLI, --algo hmc_latent, on configs/ffhq_latent.yaml in f32.
Every phase that fails ends the run with a nonzero exit code. The last lines
are the kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}. With --trace, one flagship evaluation and
one latent flagship evaluation in bf16 and in f32 are profiled
(OUT_DIR/trace_main_path.json, trace_latent_path.json,
trace_latent_f32_path.json) and nothing else runs.
"""
import contextlib
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
# dense bf16 tensor cores / fp32 outside them / fp32-accurate products on the
# tensor cores as three TF32 products each (3xTF32, K1's f32 kernel)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
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


@contextlib.contextmanager
def plain_calls(gn):
    """Count the calls of K2a's plain versions while the block runs: on the
    card the main path must make none (ops/groupnorm.py looks both up by
    module name, so the counting wrappers see every call that it makes)."""
    calls = {}
    originals = {name: getattr(gn, name) for name in ("channel_stats_plain", "group_stats_plain")}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name, fn in originals.items():
        calls[name] = 0
        setattr(gn, name, counting(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(gn, name, fn)


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
               for s in ("attention.cu", "groupnorm_bwd.cu", "groupnorm_stats.cu",
                         "stream_probe.cu")]
    for t in threads:
        t.start()
    x = torch.randn(2, 64, 64, device="cuda")
    for dt in (torch.float32, torch.bfloat16):  # K2b's Triton JIT, on plain statistics
        xs = x.to(dt)
        _, m, inv = gn.group_stats_plain(xs)
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


def attention_case(torch, attn, kc, shape, dt, g, dev):
    """K1 at (B, T, H, ch) in dt against its plain version, forward and
    gradient, and timed: the kernel, its plain version and SDPA from CUDA
    graphs of 20 calls (device ms, the host's launch cost left out: at these
    sizes it exceeds the kernels'), the kernel's eager call (host included)
    and the bound. The f32 kernel's operations are bounded by the 3xTF32
    rate (495 / 3 TFLOP/s), the fastest fp32-accurate products the card
    has; bf16's by the bf16 tensor rate. Fails the run on a disagreement;
    returns the record."""
    b, t, h, ch = shape
    q, k, v = kc.qkv_inputs(shape, dt, g, dev)
    res = kc.attention_check(q, k, v)
    # gradient through the autograd.Function vs autograd of the plain version
    qs = [x.detach().float().to(dt).requires_grad_(True) for x in (q, k, v)]
    gk = torch.autograd.grad((attn.attention(*qs).float() ** 2).sum(), qs)
    gp = torch.autograd.grad((attn.attention_plain(*qs).float() ** 2).sum(), qs)
    gerr = max(float((a.float() - b_.float()).norm() / b_.float().norm())
               for a, b_ in zip(gk, gp))
    gtol = 1e-4 if dt == torch.float32 else 3e-2
    dname = str(dt).split(".")[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms_graph(lambda: attn.attention_forward(q, k, v))
    plain = time_ms_graph(lambda: attn.attention_plain(q, k, v))
    lib = time_ms_graph(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, scale=1.0 / math.sqrt(ch)))
    eager = time_ms(lambda: attn.attention_forward(q, k, v))
    nbytes = 4 * b * t * h * ch * q.element_size()
    bms, by = bound_ms(nbytes, 4 * b * h * t * t * ch,
                       "tf32x3" if dt == torch.float32 else dname)
    print(f"K1 attention {shape} {dname}: {kc.attention_summary(res)}; grad rel "
          f"err {gerr:.2e} (tol {gtol}); device ms per call: kernel {ms:.4f}, plain "
          f"{plain:.4f}, sdpa {lib:.4f} (kernel/sdpa {ms / lib:.2f}), bound {bms:.4f} "
          f"({by}, {100 * bms / ms:.0f}% of it); eager kernel call {eager:.4f} ms")
    check(res["ok"] and gerr <= gtol, f"attention {shape} {dname} disagrees")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                max_abs_err=res["max_abs_err"], tolerance=res["tolerance"], shape=list(shape),
                dtype=dname)


def trace_eval(torch, engine, loss_fn, x, out_dir, name="main_path", what="flagship"):
    """`chip_smoke.py --trace OUT_DIR`: profile one energy+grad evaluation
    (after one untimed) with torch.profiler; print the kernels by device
    time and the busy share of the device, and write a Chrome trace to
    OUT_DIR/trace_{name}.json. Returns the device busy ms."""
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
    print(f"trace: one {what} energy+grad eval, {x.shape[0]} chains: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of wall)")
    print(events.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=70))
    print(events.table(sort_by="self_cpu_time_total", row_limit=25, max_name_column_width=70))
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    return busy_us / 1e3


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


# ---- 7. the latent path -------------------------------------------------------------------

LATENT_CFG = os.path.join(ROOT, "configs", "ffhq_latent.yaml")
LATENT_TINY_CFG = os.path.join(ROOT, "configs", "tiny_latent_test.yaml")
# useful TFLOP of one batch-8 latent energy+grad evaluation, stop-grad eps-net
# (scripts/useful_flops_latent.json, a count that does not depend on the hardware)
LATENT_USEFUL_TFLOP = 15.863
CODE_FLIP_BOUND = 0.01  # share of quantizer codes that may differ, card vs CPU (near ties)


def latent_problem(torch, np, cfg_path, dtype, dev, seed=SEED, force_not_quantize=False):
    """The latent path at a config: the LDM with seeded random weights (the
    layers the reference zero-initialises small, as in random_state_dict),
    92% random inpainting of a synthetic image, y0 = H(x) + 0.1 noise, the
    3-step DDIM ladder with the stop-grad eps-net, and the latent loss."""
    import types

    import yaml
    from nshmc_tpu_torch.cli import host_randn, image_generators
    from nshmc_tpu_torch.cli_latent import latent_configs
    from nshmc_tpu_torch.hmc import latent
    from nshmc_tpu_torch.models.ldm import LatentDiffusion
    from nshmc_tpu_torch.operators import build_operator
    from nshmc_tpu_torch.sampling import ddim
    from nshmc_tpu_torch.schedules import DDIMSequence

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    ucfg, acfg = latent_configs(cfg)
    m = cfg["model"]
    ldm = LatentDiffusion.create(ucfg, acfg, m["linear_start"], m["linear_end"], m["timesteps"],
                                 dtype=dtype, device=dev)
    ldm.unet.load_state_dict(random_state_dict(torch, ldm.unet, seed))
    ldm.first_stage.load_state_dict(random_state_dict(torch, ldm.first_stage, seed + 1))
    d, c = cfg["data"]["image_size"], cfg["data"]["channels"]
    op = build_operator("inpaint_random", c, d, np.random.default_rng(seed), device=dev)
    x_orig = 2 * torch.from_numpy(synthetic_image(np, d, seed)).to(dev)[None] - 1
    host, gen = image_generators(seed, dev)  # the CLI's draws: y0's noise from the host
    y0 = op.H_img(x_orig)
    y0 = y0 + 0.1 * host_randn(y0.shape, host, dev)
    decode_z = ddim.make_decoder(ldm.model_fn(), ldm.schedule, DDIMSequence.create(m["timesteps"], 3))
    decode_x = lambda z0: ldm.decode_first_stage(z0, force_not_quantize)
    loss_fn = latent.make_latent_loss_fn(decode_z, decode_x, op, y0[0])
    z_shape = (ucfg.image_size, ucfg.image_size, ucfg.in_channels)
    return types.SimpleNamespace(ldm=ldm, loss_fn=loss_fn, decode_z=decode_z, gen=gen,
                                 z_shape=z_shape, z_t=host_randn((CHAINS, *z_shape), host, dev))


def phase_latent_small(torch, np, engine):
    """(a) The tiny latent config in f32: the latent loss, the DDIM-decoded
    z0 and the z-gradient on the card (kernels) against the CPU (plain
    versions). The quantizer's argmin over the codebook can flip at a near
    tie, so the decode without quantization is held to the tolerance, and
    the share of code indices that differ is reported and bounded; the
    quantized loss and gradient are held to the tolerance where no code
    differs. Returns the share."""
    z = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(SEED))
    results, codes = {}, {}
    for dev in ("cpu", "cuda"):
        for fnq in (False, True):
            p = latent_problem(torch, np, LATENT_TINY_CFG, torch.float32, dev,
                               force_not_quantize=fnq)
            loss, z0, grad = engine.value_and_grad(p.loss_fn, z.to(dev))
            results[(dev, fnq)] = [t.detach().cpu() for t in (loss, z0, grad)]
        codes[dev] = p.ldm.first_stage.quantize.indices(
            results[("cpu", True)][1].to(dev)).cpu()  # the same z0 on both
        codes[dev + "_own"] = p.ldm.first_stage.quantize.indices(z0).cpu()
    rel = {fnq: [float((a - b).norm() / b.norm()) for a, b in
                 zip(results[("cuda", fnq)], results[("cpu", fnq)])] for fnq in (False, True)}
    share = float((codes["cuda"] != codes["cpu"]).float().mean())
    share_own = float((codes["cuda_own"] != codes["cpu_own"]).float().mean())
    print(f"latent small reference (tiny latent config, f32, card vs CPU): relative L2 error "
          f"without quantization: loss {rel[True][0]:.2e}, z0 {rel[True][1]:.2e}, gradient "
          f"{rel[True][2]:.2e} (tolerance 2e-4); quantized: loss {rel[False][0]:.2e}, gradient "
          f"{rel[False][2]:.2e}; codes that differ on the same z0 {share:.4f}, on each "
          f"device's own z0 {share_own:.4f} of {codes['cpu'].numel()} "
          f"(bound {CODE_FLIP_BOUND})")
    check(max(rel[True]) < 2e-4, f"latent loss without quantization disagrees: {rel[True]}")
    check(max(share, share_own) <= CODE_FLIP_BOUND, f"quantizer codes differ: {share}")
    if share_own == 0:
        check(max(rel[False]) < 2e-4, f"quantized latent loss disagrees: {rel[False]}")
    return max(share, share_own)


def latent_finite_or_fail(torch, p, z):
    """The energy and its gradient at the start state are finite; where not,
    name the first stage of the loss that is not, and fail."""
    from nshmc_tpu_torch.hmc import engine

    loss, _, grad = engine.value_and_grad(p.loss_fn, z)
    if bool(torch.isfinite(loss).all()) and bool(torch.isfinite(grad).all()):
        return loss
    with torch.no_grad():
        z0 = p.decode_z(z)
        x0 = p.ldm.decode_first_stage(z0)
    fail(f"latent energy not finite at the start state: DDIM z0 finite "
         f"{bool(torch.isfinite(z0).all())}, decoded x0 finite {bool(torch.isfinite(x0).all())}, "
         f"loss {loss.tolist()}, gradient finite {bool(torch.isfinite(grad).all())}")


def phase_latent_flagship(torch, np, engine, kc, gn, counters, trace_dir=None, dtype=None):
    """(b) The latent flagship: configs/ffhq_latent.yaml at full width, in
    `dtype` (bf16; f32 is the latent CLI's type), random weights from seed 0,
    92% random inpainting at 256^2, 3-step DDIM, 8 chains, MH attempts at
    tau 1.0 / eps 0.05 (L = 20) through the port's latent engine, y0's noise
    and z_T drawn as the CLI draws them, every kernel count set to 0 just
    before and read just after. In bf16, 3 attempts: the anneal lasts one
    and one sample is kept, and chain 0's accept uniform is 0, so it accepts
    every finite proposal and the run reaches the geometric sigma update,
    the post-anneal pin of (tau, eps) and the sample ring. In f32, 2 anneal
    attempts, under torch's default TF32 settings (cuDNN convolutions in
    TF32, matmuls not), as the CLI runs. With `trace_dir`, profiles one
    evaluation instead and returns its device busy ms."""
    from nshmc_tpu_torch.hmc import latent

    dev = torch.device("cuda")
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    dname = str(dtype).split(".")[1]
    t0 = time.time()
    p = latent_problem(torch, np, LATENT_CFG, dtype, dev)
    from nshmc_tpu_torch.models.unet import AttentionBlock

    # the attention inputs come out of each block's qkv projection in its
    # weight's dtype, which picks K1's kernel
    check(all(mod.qkv.weight.dtype == dtype for mod in p.ldm.unet.modules()
              if isinstance(mod, AttentionBlock)),
          f"the latent U-Net's attention blocks are not all {dname}")
    hcfg = (latent.LatentHMCConfig(sigma_0=0.1, sigma_y0=1.0, tau=1.0, epsilon=0.05,
                                   epochs=2, sampling=0, keep_samples=1) if f32 else
            latent.LatentHMCConfig(sigma_0=0.1, sigma_y0=1.0, tau=1.0, epsilon=0.05, epochs=1,
                                   sampling=1, keep_samples=1))
    state = latent.init_latent_chains(hcfg, CHAINS, p.z_shape, dev, z=p.z_t)
    print(f"latent flagship ({dname}) built in {time.time() - t0:.1f} s")
    with torch.no_grad():  # the shapes each kernel sees, by forward hooks
        unet_gn, unet_attn, unet_norm = kc.count_sites(p.ldm.unet, lambda: p.ldm.unet(
            state.z, torch.full((CHAINS,), 500.0, device=dev)))
        dec_gn, dec_attn, dec_norm = kc.count_sites(p.ldm.first_stage.decoder,
                                                    lambda: p.ldm.decode_first_stage(state.z))
    check(unet_gn == kc.LATENT_UNET_GN_SITES, f"latent U-Net GN+SiLU sites {unet_gn}")
    check(unet_attn == kc.LATENT_ATTN_SITES, f"latent U-Net attention blocks {unet_attn}")
    check(unet_norm == kc.LATENT_UNET_NORM_SITES, f"latent U-Net GroupNorm32 sites {unet_norm}")
    check(dec_gn == kc.VQ_DECODER_GN_SITES and not dec_attn, f"VQ decoder sites {dec_gn}")
    check(dec_norm == kc.VQ_DECODER_NORM_SITES, f"VQ decoder GroupNorm32 sites {dec_norm}")
    n_unet_gn, n_attn, n_dec_gn, n_unet_norm, n_dec_norm = (
        sum(v.values()) for v in (unet_gn, unet_attn, dec_gn, unet_norm, dec_norm))
    print(f"latent U-Net forward: {n_unet_gn} GN+SiLU sites, {n_attn} attention blocks "
          f"{dict(unet_attn)}, {n_unet_norm} GroupNorm32 sites; VQ decoder: {n_dec_gn} GN+SiLU "
          f"sites at eps 1e-6 {dict(dec_gn)}, {n_dec_norm} GroupNorm32 site")
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = f32  # f32: torch's default, under which the CLI runs
    try:
        loss0 = latent_finite_or_fail(torch, p, state.z)
        print(f"latent energy ({dname}) at the start state finite: data loss "
              f"{[round(v, 1) for v in loss0.tolist()]}")
        if trace_dir is not None:
            return trace_eval(torch, engine, p.loss_fn, state.z, trace_dir,
                              "latent_path" if not f32 else "latent_f32_path",
                              f"latent flagship {dname}")
        return latent_run(torch, kc, gn, p, hcfg, state, counters, dtype,
                          (n_unet_gn, n_attn, n_dec_gn, n_unet_norm, n_dec_norm))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before


def latent_run(torch, kc, gn, p, hcfg, state, counters, dtype, sites):
    """The latent flagship's HMC run of `phase_latent_flagship` in `dtype`,
    with `sites` (U-Net GN+SiLU sites, attention blocks, decoder GN+SiLU
    sites, U-Net and decoder GroupNorm32 sites a forward): its launch counts,
    no call of K2a's plain versions, and the chain checks; returns the
    path's record."""
    from nshmc_tpu_torch.hmc import latent

    dev, dname = torch.device("cuda"), str(dtype).split(".")[1]
    n_unet_gn, n_attn, n_dec_gn, n_unet_norm, n_dec_norm = sites
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    for f in (*counters.values(), gn.groupnorm_silu_backward):
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    round_s, ring = [], {}

    def timed(states, rnd):
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())
        if rnd == 1:  # the z0 the ring must hold after the last post-anneal accept
            ring["z0"] = states.last_z0_accept[0].clone()

    def draws():  # the engine's own draws, but chain 0 accepts every finite proposal
        for _ in range(hcfg.total_attempts):
            p0 = torch.randn(state.z.shape, generator=p.gen, device=dev) * math.sqrt(hcfg.m)
            u = torch.rand((CHAINS,), generator=p.gen, device=dev)
            u[0] = 0.0
            yield p0, u

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_calls(gn) as plain:
        out = latent.run_latent_hmc(p.loss_fn, hcfg, state, p.gen, draws=draws(),
                                    callback=timed)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    bwd_calls = gn.groupnorm_silu_backward.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    evals = hcfg.n_leapfrog + 1
    n_evals = evals * hcfg.total_attempts
    steps = [b - a for a, b in zip([t0] + round_s[:-1], round_s)]
    evals_per_s = evals * len(steps[1:]) / sum(steps[1:])
    print(f"latent path ({dname}): {len(steps)} MH attempts x {evals} energy+grad evals, "
          f"{CHAINS} chains; attempt times {[round(v, 3) for v in steps]} s; {evals_per_s:.3f} "
          f"energy+grad evals/s (attempts 2+), useful {LATENT_USEFUL_TFLOP * evals_per_s:.1f} "
          f"TFLOP/s; peak memory {peak_gb:.2f} GB")
    print(f"latent path ({dname}) kernel launches: {launches}; GN+SiLU backward calls "
          f"{bwd_calls} (per energy+grad eval: { {k: v / n_evals for k, v in launches.items()} })")
    # K1 at every attention block of the 3 eps-net forwards; K2a at every
    # GN+SiLU and GroupNorm32 site of those and of the decoder, K2b at every
    # GN+SiLU site; K2c at the decoder's only (the eps-net is stop-gradded),
    # each by the design bwd_design picks
    want_bwd = {"gn_backward": 0, "gn_backward_twopass": 0}
    for shape, n in kc.VQ_DECODER_GN_SITES.items():
        want_bwd[BWD_KERNELS[gn.bwd_design(*shape, itemsize, sms)]] += n * n_evals
    k1 = "attention_f32" if dtype == torch.float32 else "attention"
    want = {k1: 3 * n_attn * n_evals,
            "gn_stats": (3 * (n_unet_gn + n_unet_norm) + n_dec_gn + n_dec_norm) * n_evals,
            "gn_apply": (3 * n_unet_gn + n_dec_gn) * n_evals, **want_bwd}
    check(not any(plain.values()), f"latent path ({dname}): K2a's plain versions ran on the "
                                   f"card: {plain}")
    check(bwd_calls == n_dec_gn * n_evals,
          f"{bwd_calls} GN+SiLU backward calls, {n_dec_gn * n_evals} expected: one per VQ "
          f"decoder site, none in the stop-gradded eps-net")
    for k, v in launches.items():
        check(v == want.get(k, 0), f"latent path ({dname}): kernel {k} launched {v} times, "
                                   f"{want.get(k, 0)} expected")
    check(bool(torch.isfinite(out.z).all()), "latent chain state is not finite")
    check(int(out.accepted[0]) == hcfg.total_attempts,
          f"chain 0 did not accept every proposal: accepted {out.accepted.tolist()}")
    if hcfg.sampling:
        check(int(out.n_kept[0]) == 2, f"chain 0 kept {out.n_kept.tolist()} samples")
        check(abs(float(out.tau[0]) - hcfg.post_tau) < 1e-6
              and abs(float(out.epsilon[0]) - hcfg.post_epsilon) < 1e-6
              and abs(float(out.sigma_y[0]) - hcfg.sigma_0) < 1e-6,
              f"chain 0 was not pinned after the anneal: {out.tau[0]}, {out.epsilon[0]}, "
              f"{out.sigma_y[0]}")
        check(torch.equal(out.samples[0, -1], ring["z0"]),
              "chain 0's ring does not hold the z0 of its previous accepted proposal")
    print(f"latent path ({dname}) state: accepted {out.accepted.tolist()}, n_kept "
          f"{out.n_kept.tolist()}, tau {[round(v, 4) for v in out.tau.tolist()]}, sigma_y "
          f"{[round(v, 4) for v in out.sigma_y.tolist()]}, last loss "
          f"{[round(v, 1) for v in out.last_loss.tolist()]}")
    return dict(launches=launches, evals_per_s=evals_per_s, peak_gb=peak_gb,
                useful_tflops=LATENT_USEFUL_TFLOP * evals_per_s, n_leapfrog=hcfg.n_leapfrog,
                attempts=hcfg.total_attempts, attempt_s=steps, dtype=dname)


def phase_latent_kernels(torch, attn, gn, kc, stats_records):
    """(c) K1 at the latent U-Net's three attention shapes in bf16 and f32,
    and (d) K2a, K2b and K2c at the VQ decoder's GN+SiLU sites with eps
    1e-6 (both dtypes, both affine forms; K2a and K2c two calls
    bit-identical, K2c each design that can take the call and the wrapper),
    K2a and K2b also at the latent U-Net's sites and K2a at the GroupNorm32
    sites, each against its plain version; K1 and the VQ decoder's K2b and
    K2c timed in both dtypes, K2a's times taken from `stats_records` (phase
    3's groupnorm_stats_variants run) at every latent site. Returns
    {kernel: [records]}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"attention": [], "gn_stats": [], "gn_apply": [], "gn_backward": [],
           "gn_backward_twopass": []}
    for shape in kc.LATENT_ATTN_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            out["attention"].append(attention_case(torch, attn, kc, shape, dt, g, dev))
    worst = {}
    for part, (eps, sites) in kc.LATENT_GN_SITES.items():
        for shape in sites:
            b, r, cc = shape
            for dt in (torch.bfloat16, torch.float32):
                dname = str(dt).split(".")[1]
                x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
                st = kc.gn_stats_check(x, gn.NUM_GROUPS, eps, g)
                check(st["ok"], f"K2a {part} {shape} {dname} eps {eps:g}: "
                                f"{kc.stats_summary(st)}")
                mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r, gn.NUM_GROUPS, eps)
                for form in kc.AFFINE_FORMS:
                    aff = (cc,) if form == "per_channel" else (b, cc)
                    sc = 1 + 0.3 * torch.randn(aff, generator=g, device=dev)
                    bi = 0.3 * torch.randn(aff, generator=g, device=dev)
                    y_k = gn.normalize_silu(x, mean_c, inv_c, sc, bi)
                    y_p = gn.normalize_silu_plain(x, mean_c, inv_c, sc, bi)
                    diff = (y_k.float() - y_p.float()).abs()
                    tol = 1e-4 if dt == torch.float32 else 2 ** -7 * y_p.float().abs() + 1e-3
                    check(bool((diff <= tol).all()),
                          f"K2b {part} {shape} {dname} {form}: apply {float(diff.max()):.2e}")
                    worst[(part, dname)] = max(worst.get((part, dname), 0.0), float(diff.max()))
                    if part != "vq_decoder":
                        continue
                    inputs = kc.gn_inputs(shape, dt, form, g, dev, eps)
                    for design in (*gn.bwd_designs(*shape, dt.itemsize, sms), None):
                        res = kc.gn_backward_check(*inputs, design=design)
                        check(res["ok"], f"K2c {design or 'wrapper'} {shape} {dname} {form} "
                                         f"eps {eps:g}: {res}")
                if part == "vq_decoder":
                    out["gn_apply"].append(gn_apply_times(torch, gn, x, eps))
                    design = gn.bwd_design(*shape, dt.itemsize, sms)
                    out[BWD_KERNELS[design]].append(gn_backward_times(
                        torch, gn, kc, shape, dt, design, eps, g, dev))
    for (shape, eps) in [*((s_, 1e-6) for s_ in kc.VQ_DECODER_NORM_SITES),
                         *((s_, 1e-5) for s_ in kc.LATENT_UNET_NORM_SITES)]:
        for dt in (torch.bfloat16, torch.float32):
            x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
            st = kc.gn_stats_check(x, gn.NUM_GROUPS, eps, g)
            check(st["ok"], f"K2a GroupNorm32 site {shape} {dt} eps {eps:g}: "
                            f"{kc.stats_summary(st)}")
    out["gn_stats"] = [stats_record(v) for v in stats_records if v["path"] == "latent"]
    print(f"K2 at the latent sites agree (eps 1e-6 at the VQ decoder's, 1e-5 at the U-Net's; "
          f"K2a also at the GroupNorm32 sites, two calls bit-identical): "
          f"apply worst abs err {worst}; K2c at every VQ decoder site, each design that can "
          f"take it and the wrapper, two calls bit-identical")
    return out


def stats_record(v):
    """A groupnorm_stats_variants record as a K2a record of the kernels
    line: the one launch's device ms (CUDA graphs) and eager ms, its plain
    version's, `torch.var_mean`'s (library) and the Triton chain's it
    replaced (earlier), and the bound from the record's shape."""
    b, r, cc = v["shape"]
    n, es = b * r * cc, 2 if v["dtype"] == "bfloat16" else 4
    bms, by = bound_ms(n * es + b * 4 * cc * 4, 3 * n, "float32")
    return dict(shape=v["shape"], dtype=v["dtype"], eps=v["eps"], ms=v["new_ms"],
                eager_ms=v["new_eager_ms"], plain_ms=v["plain_ms"], library_ms=v["var_mean_ms"],
                earlier_ms=v["triton_chain_ms"], earlier_eager_ms=v["triton_chain_eager_ms"],
                bound_ms=bms, bound_by=by)


def gn_apply_times(torch, gn, x, eps):
    """K2b at x (B, R, C), bf16 or f32: kernel and plain device ms from CUDA
    graphs (at the smaller sites the host's launch of a Triton kernel
    outlasts the kernel), the kernel's eager call (CUDA events, host
    included) and the bound."""
    b, r, cc = x.shape
    n, es = b * r * cc, x.element_size()
    dname = str(x.dtype).split(".")[1]
    mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r, gn.NUM_GROUPS, eps)
    sc, bi = torch.ones((b, cc), device=x.device), torch.zeros((b, cc), device=x.device)
    run = lambda: gn.normalize_silu(x, mean_c, inv_c, sc, bi)
    plain_run = lambda: gn.normalize_silu_plain(x, mean_c, inv_c, sc, bi)
    bms, by = bound_ms(2 * n * es + 4 * b * cc * 4, 8 * n, "float32")
    ms, plain, eager = time_ms_graph(run), time_ms_graph(plain_run), time_ms(run)
    print(f"K2 apply {tuple(x.shape)} {dname} (VQ decoder site): kernel {ms:.4f} ms (CUDA "
          f"graphs; eager {eager:.4f}), plain {plain:.4f}, bound {bms:.4f} ({by}), "
          f"{100 * bms / ms:.0f}% of bound")
    return dict(shape=list(x.shape), dtype=dname, ms=ms, eager_ms=eager, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None)


def gn_backward_times(torch, gn, kc, shape, dt, design, eps, g, dev):
    """K2c's picked design at a VQ decoder site in dt: device ms from CUDA
    graphs, the plain version's ms (CUDA events, as in phase 3), the
    three-pass bound, and
    the yardstick of phase 3 (the backward of F.group_norm + F.silu with a
    (C,) affine, not the same function)."""
    inputs = kc.gn_inputs(shape, dt, "per_batch_channel", g, dev, eps)
    ms = time_ms_graph(lambda: kc.GN_BWD_DESIGNS[design](*inputs))
    plain = time_ms(lambda: gn.groupnorm_silu_backward_plain(*inputs))
    b, r, cc = shape
    x, gk, _, _, sc, bi = inputs
    side = math.isqrt(r)
    x4 = x.reshape(b, side, side, cc).permute(0, 3, 1, 2).detach().requires_grad_(True)
    y4 = torch.nn.functional.silu(torch.nn.functional.group_norm(
        x4, 32, sc[0].to(dt), bi[0].to(dt), eps))
    g4 = gk.reshape(b, side, side, cc).permute(0, 3, 1, 2)
    lib = time_ms(lambda: torch.autograd.grad(y4, x4, g4, retain_graph=True))
    del x4, y4
    n, es = b * r * cc, dt.itemsize
    dname = str(dt).split(".")[1]
    bms, by = bound_ms(3 * n * es + 6 * b * cc * 4, GN_BWD_OPS * n, "float32")
    print(f"K2c {design} {shape} {dname} (VQ decoder site): kernel {ms:.4f} ms (CUDA graphs), "
          f"plain {plain:.4f}, bound {bms:.4f} ({by}), {100 * bms / ms:.0f}% of bound; "
          f"F.group_norm+F.silu backward {lib:.4f} ms")
    return dict(shape=list(shape), dtype=dname, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def phase_latent_cli(np):
    """(e) The port's CLI, --algo hmc_latent on configs/ffhq_latent.yaml
    (f32, 2 chains, one anneal attempt and two post-anneal ones at L = 2):
    artifacts and the summary line."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        from PIL import Image

        Image.fromarray((synthetic_image(np, 256, SEED + 4) * 255).astype(np.uint8)).save(
            os.path.join(data, "face.png"))
        cmd = [sys.executable, "-m", "nshmc_tpu_torch.cli", "--config", LATENT_CFG,
               "--device", "cuda", "--algo", "hmc_latent", "--deg", "inpaint_random",
               "--chains", "2", "--tau", "0.1", "--epsilon", "0.05", "--latent_epochs", "1",
               "--latent_sampling", "1", "--verbose", "--data_path", data,
               "-i", os.path.join(tmp, "out")]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        check(r.returncode == 0 and lines and lines[-1].startswith('{"summary"'),
              f"latent CLI failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        summary = json.loads(lines[-1])["summary"]
        check(math.isfinite(summary.get("psnr", float("nan"))), f"latent CLI summary {summary}")
        for f in ("0.png", "orig_0.png", "y0_0.png", "metrics.jsonl"):
            check(os.path.exists(os.path.join(tmp, "out", f)), f"latent CLI did not write {f}")
        attempts = [x for x in lines if x.strip().startswith("attempt ")]
        check(len(attempts) == 3, f"latent CLI ran {len(attempts)} attempts, 3 expected")
        print(f"latent CLI (configs/ffhq_latent.yaml, f32, 2 chains, cuda) in "
              f"{time.time() - t0:.1f} s: {attempts[-1].strip()}; {lines[-1]}")


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
        from nshmc_tpu_torch.cli import host_randn, image_generators
        from nshmc_tpu_torch.hmc import engine
        from nshmc_tpu_torch.models import unet
        from nshmc_tpu_torch.operators import build_operator
        from nshmc_tpu_torch.ops import _build as build
        from nshmc_tpu_torch.ops import attention as attn
        from nshmc_tpu_torch.ops import groupnorm as gn
        from nshmc_tpu_torch.ops import stream_probe as sp
        from nshmc_tpu_torch.sampling import ddim
        from nshmc_tpu_torch.scripts import groupnorm_stats_variants as stats_variants
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
    host, gen = image_generators(SEED, dev)  # the CLI's draws
    x_orig = 2 * torch.from_numpy(synthetic_image(np, d, SEED)).to(dev)[None] - 1
    sigma_0 = 2 * 0.05
    y0 = op.H_img(x_orig)
    y0 = y0 + sigma_0 * host_randn(y0.shape, host, dev)
    hcfg = engine.HMCConfig(sigma_0=sigma_0, tau=1.0, epsilon=0.05, epochs=1, sampling=1,
                            max_attempts=ATTEMPTS)
    loss_fn = engine.make_pixel_loss_fn(decode, op, y0[0])
    state = engine.init_chains(hcfg, CHAINS, (d, d, c), dev,
                               x=host_randn((CHAINS, d, d, c), host, dev))

    # one no-grad forward at the main path's batch records the shapes each
    # kernel sees (GroupNorm+SiLU sites and attention blocks)
    warm = []
    with torch.no_grad():
        gn_shapes, attn_sites, norm_shapes = kc.count_sites(model, lambda: warm.append(
            model(state.x, torch.full((CHAINS,), 750.0, device=dev))))
    warm = warm[0]
    torch.cuda.synchronize()
    check(torch.isfinite(warm).all().item() and warm.shape == (CHAINS, d, d, 6),
          "flagship U-Net forward is not finite / has the wrong shape")
    n_gn, n_attn = sum(gn_shapes.values()), sum(attn_sites.values())
    print(f"flagship U-Net forward: {n_gn} GroupNorm+SiLU sites over {len(gn_shapes)} shapes, "
          f"{n_attn} attention blocks over {len(attn_sites)} shapes")

    if trace_dir is not None:
        trace_eval(torch, engine, loss_fn, state.x, trace_dir)
        del model, state, loss_fn, decode
        for dt in (torch.bfloat16, torch.float32):
            phase_latent_flagship(torch, np, engine, kc, gn, None, trace_dir, dt)
        return

    # the main path's kernels, and the probe kernels, which it must not run
    check(gn_shapes == kc.FLAGSHIP_GN_SITES,
          f"GN+SiLU sites {gn_shapes} are not kernel_check.FLAGSHIP_GN_SITES")
    check(norm_shapes == kc.FLAGSHIP_NORM_SITES,
          f"GroupNorm32 sites {norm_shapes} are not kernel_check.FLAGSHIP_NORM_SITES")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    on_path = set(MAIN_PATH_KERNELS) | {BWD_KERNELS[gn.bwd_design(*shape, 2, sms)]
                                        for shape in kc.FLAGSHIP_GN_SITES}
    counters = {"attention": attn.KERNEL_LAUNCHES[torch.bfloat16],
                "attention_f32": attn.KERNEL_LAUNCHES[torch.float32], "gn_stats": gn.group_stats,
                "gn_stats_triton_chain": stats_variants.triton_chain,
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
    run = {}  # forward hooks count every GN+SiLU and GroupNorm32 call, recomputes included
    with plain_calls(gn) as plain:
        gn_calls, _, norm_calls = kc.count_sites(model, lambda: run.setdefault(
            "out", engine.run_hmc(loss_fn, hcfg, state, gen, draws=draws(), callback=timed)))
    out = run["out"]
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
    n_evals = evals * len(steps)
    n_silu, n_norm = sum(gn_calls.values()), sum(norm_calls.values())
    print(f"main path K2a launches per energy+grad eval by shape (hooks; GN+SiLU, then "
          f"GroupNorm32): { {str(k): v / n_evals for k, v in sorted(gn_calls.items())} }, "
          f"{ {str(k): v / n_evals for k, v in sorted(norm_calls.items())} }; plain "
          f"K2a calls {plain}")
    check(launches["gn_stats"] == n_silu + n_norm and launches["gn_apply"] == n_silu,
          f"K2a launched {launches['gn_stats']} times and K2b {launches['gn_apply']} for "
          f"{n_silu} GN+SiLU and {n_norm} GroupNorm32 calls")
    check(not any(plain.values()), f"K2a's plain versions ran on the card: {plain}")
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

    attn_f32 = []  # K1's f32 kernel at the flagship's shapes (its pixel path: --no-bf16)
    for shape in sorted(attn_sites):
        for dt in (torch.bfloat16, torch.float32):
            r_ = attention_case(torch, attn, kc, shape, dt, g, dev)
            if (*shape, dt) == (CHAINS, 256, 8, 64, torch.bfloat16):
                rec("attention", **r_)
            if dt == torch.float32:
                attn_f32.append(r_)
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

    stats_worst = {}  # dtype -> worst of each K2a measure over the shapes
    for shape in dict.fromkeys([*sorted(gn_shapes), *sorted(norm_shapes), *kc.GN_SHAPES]):
        for dt in (torch.bfloat16, torch.float32):
            x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
            res = kc.gn_stats_check(x, gn.NUM_GROUPS, gn.EPS, g)
            check(res["ok"], f"K2a {shape} {dt}: {kc.stats_summary(res)}")
            w = stats_worst.setdefault(dt, dict.fromkeys(("sums_rel", "mean_err", "inv_rel",
                                                          "apply_err"), 0.0))
            for k_ in w:
                w[k_] = max(w[k_], res[k_])
            if (shape, dt) == ((CHAINS, d * d, mcfg.model_channels), torch.bfloat16):
                hot_stats = res
    for dt in (torch.bfloat16, torch.float32):
        res = kc.gn_clip_check(dt, dev)
        check(res["ok"], f"K2a clip case {dt}: {res}")
        print(f"K2a clip case (8, 4096, 512) {dt} eps 1e-6: mean_c, inv_c finite, "
              f"{res['negative_groups']} groups below 0 before the clip (finiteness asserted: "
              f"the true variances lie below the fp32 sums' rounding)")
    print(f"K2a (one launch): {len(gn_shapes)} GN+SiLU, {len(norm_shapes)} GroupNorm32 and "
          f"{len(kc.GN_SHAPES)} edge shapes x (bf16, f32) agree, two calls bit-identical: "
          f"worst {json.dumps({str(k).split('.')[1]: v for k, v in stats_worst.items()})} "
          f"({kc.STATS_TOL})")

    worst = {}  # K2b on plain statistics, both affine forms
    for (b, r, cc) in sorted(gn_shapes):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            x = (1.5 * torch.randn((b, r, cc), generator=g, device=dev) + 0.3).to(dt)
            mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r)
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
                check(ok, f"K2b {(b, r, cc)} {dname} {form}: apply max {float(diff.max()):.2e}")
                key = ("gn_apply", dname, (b, r, cc))
                worst[key] = max(worst.get(key, 0.0), float(diff.max()))
    top = lambda kern, dname: max(v for k, v in worst.items() if k[:2] == (kern, dname))
    print(f"K2b: {len(gn_shapes)} main-path shapes x (bf16, f32) x (per-channel, "
          f"per-(batch, channel) affine) agree: worst abs err f32 "
          f"{top('gn_apply', 'float32'):.2e} (tol 1e-4), bf16 {top('gn_apply', 'bfloat16'):.2e} "
          f"(tol 2^-7 |y| + 1e-3)")

    # K2a's four ways side by side at every K2a site of the three paths, in this call
    stats_records = stats_variants.main([])
    check(all(v["agrees"] for v in stats_records), "K2a disagrees at a variants site")
    print(f"K2a variants: {json.dumps(stats_variants.summary(stats_records))}")
    stats_by = {(tuple(v["shape"]), v["dtype"]): v for v in stats_records}
    for (b, r, cc), n_sites in sorted(gn_shapes.items()):  # K2b and the whole site, bf16
        x = (1.5 * torch.randn((b, r, cc), generator=g, device=dev) + 0.3).to(torch.bfloat16)
        sc = 1 + 0.3 * torch.randn((b, cc), generator=g, device=dev)
        bi = 0.3 * torch.randn((b, cc), generator=g, device=dev)
        mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r)
        ap_ms = time_ms(lambda: gn.normalize_silu(x, mean_c, inv_c, sc, bi))
        ap_plain = time_ms(lambda: gn.normalize_silu_plain(x, mean_c, inv_c, sc, bi))
        whole = time_ms(lambda: gn.groupnorm_silu(x, sc, bi))
        x4 = x.reshape(b, int(math.isqrt(r)), -1, cc).permute(0, 3, 1, 2)  # NCHW channels_last
        w1, b1 = sc[0].to(x.dtype), bi[0].to(x.dtype)
        lib = time_ms(lambda: torch.nn.functional.silu(
            torch.nn.functional.group_norm(x4, 32, w1, b1, 1e-5)))
        n = b * r * cc
        st = stats_by[((b, r, cc), "bfloat16")]
        st_b, st_by = bound_ms(n * 2 + b * 4 * cc * 4, 3 * n, "float32")
        ap_b, ap_by = bound_ms(2 * n * 2 + 4 * b * cc * 4, 8 * n, "float32")
        print(f"K2 {(b, r, cc)} bf16, {n_sites} sites/forward: stats {st['new_ms']:.4f} ms "
              f"(CUDA graphs; Triton chain {st['triton_chain_ms']:.4f}, var_mean "
              f"{st['var_mean_ms']:.4f}, plain {st['plain_ms']:.4f}, bound {st_b:.4f}), apply "
              f"{ap_ms:.4f} ms (plain {ap_plain:.4f}, bound {ap_b:.4f}); whole GN+SiLU "
              f"{whole:.4f} ms vs F.group_norm+F.silu {lib:.4f} ms (eager)")
        if (b, r, cc) == (CHAINS, d * d, mcfg.model_channels):
            common = dict(shape=[b, r, cc], dtype="bfloat16")
            rec("gn_stats", ms=st["new_ms"], plain_ms=st["plain_ms"], bound_ms=st_b,
                bound_by=st_by, library_ms=st["var_mean_ms"], earlier_ms=st["triton_chain_ms"],
                eager_ms=st["new_eager_ms"], max_abs_err=hot_stats["sums_abs"],
                tolerance=kc.STATS_TOL, **common)
            rec("gn_apply", ms=ap_ms, plain_ms=ap_plain, bound_ms=ap_b, bound_by=ap_by,
                library_ms=None, max_abs_err=worst[("gn_apply", "bfloat16", (b, r, cc))],
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

    # ---- 7. the latent path ----------------------------------------------------------------
    t0 = time.time()
    code_share = phase_latent_small(torch, np, engine)
    latent_bf16 = phase_latent_flagship(torch, np, engine, kc, gn, counters)
    latent_f32 = phase_latent_flagship(torch, np, engine, kc, gn, counters, dtype=torch.float32)
    latent_kernels = phase_latent_kernels(torch, attn, gn, kc, stats_records)
    phase_latent_cli(np)
    print(f"phase 7 (the latent path) took {time.time() - t0:.1f} s")

    # K1's f32 kernel: its record at the f32 latent path's hot shape
    for r_ in latent_kernels["attention"]:
        if r_["dtype"] == "float32" and r_["shape"] == [CHAINS, 1024, 14, 32]:
            rec("attention_f32", **r_)
    probe_src = "nshmc_tpu_torch/csrc/stream_probe.cu"
    attn_src = ("cuda", "nshmc_tpu_torch/csrc/attention.cu", "nshmc_tpu/ops/attention.py:44")
    sources = {"attention": attn_src, "attention_f32": attn_src,
               "gn_stats": ("cuda", "nshmc_tpu_torch/csrc/groupnorm_stats.cu",
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
    # each HMC run's launch counts by kernel, each kernel counted where it launches
    paths = {"flagship bf16": launches, "latent bf16": latent_bf16["launches"],
             "latent f32": latent_f32["launches"]}

    kernels = []
    for name, (route, src, replaces) in sources.items():
        r_ = records[name]
        on_main = name in MAIN_PATH_KERNELS or name in BWD_KERNELS.values()
        # `launches`: the count of the kernel's own path (the flagship HMC run,
        # the f32 latent HMC run for K1's f32 kernel, or the probe's timed
        # cases for P1-P4), each set to 0 just before it; `path_launches`:
        # its count over each HMC run of this script
        own = ("flagship bf16" if on_main else "latent f32" if name == "attention_f32"
               else None)
        # K1's records of both dtypes sit under "attention"
        key, kdt = (("attention", "float32" if name == "attention_f32" else "bfloat16")
                    if name.startswith("attention") else (name, None))
        kernels.append({"name": name, "route": route, "source": src, "replaces": replaces,
                        "launches": paths[own][name] if own else r_["launches"],
                        "path": own or "stream probe",
                        "path_launches": {pth: counts[name] for pth, counts in paths.items()},
                        "latent_shapes": [x for x in latent_kernels.get(key, [])
                                          if kdt in (None, x["dtype"])],
                        **({"flagship_shapes": attn_f32} if name == "attention_f32" else {}),
                        **({"flagship_shapes": [stats_record(v) for v in stats_records
                                                if v["path"] == "flagship"]}
                           if name == "gn_stats" else {}),
                        "max_abs_err": r_["max_abs_err"],
                        "ms": r_["ms"], "plain_ms": r_["plain_ms"], "bound_ms": r_["bound_ms"],
                        "bound_by": r_["bound_by"], "library_ms": r_["library_ms"],
                        "shape": r_["shape"], "dtype": r_["dtype"],
                        "tolerance": r_["tolerance"],
                        **{k: r_[k] for k in ("five_pass_floor_ms", "timing",
                                              "picked_at_this_shape", "earlier_ms", "eager_ms")
                           if k in r_}})

    def path_record(run):
        return {"energy_grad_evals_per_s": run["evals_per_s"], "peak_memory_gb": run["peak_gb"],
                "useful_tflop_per_s": run["useful_tflops"], "chains": CHAINS,
                "attempts": run["attempts"], "n_leapfrog": run["n_leapfrog"],
                "attempt_s": run["attempt_s"], "dtype": run["dtype"]}

    print(json.dumps({"kernels": kernels, "main_path": {
        "energy_grad_evals_per_s": evals_per_s, "peak_memory_gb": peak_gb,
        "chains": CHAINS, "attempts": ATTEMPTS, "n_leapfrog": hcfg.n_leapfrog},
        "latent_path": {**path_record(latent_bf16), "quantizer_codes_differing": code_share},
        "latent_path_f32": path_record(latent_f32)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
