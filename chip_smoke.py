#!/usr/bin/env python3
"""Chip smoke run of nshmc_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --trace OUT_DIR  # profile one flagship and two latent evaluations
    python3 chip_smoke.py --sd             # the build and phase 13 alone

It builds the port's kernels from the sources in this checkout and then:
  1. holds the port's output against its plain-PyTorch path on the CPU on a
     small input (the tiny config's pixel loss and gradient, f32);
  2. drives the main path: the flagship pixel noise-space HMC through the
     port's engine — ADM U-Net at 256^2 (configs/ffhq.yaml, random weights
     from a seed), 3-step DDIM, 92% random inpainting, tau 1.0 / eps 0.05
     (L = 20), 8 chains as the batch, bf16 — for a few MH attempts, each
     evaluation a replay of the DDIM decoder's CUDA graphs, with every
     kernel's launches read from a device trace of the run (K1's f32
     kernel: none; K2a once for each GN+SiLU and GroupNorm32 call that
     forward hooks count in one eager evaluation, times the evaluations,
     K2b once for each GN+SiLU call, K2c once for each GN+SiLU call of each
     U-Net forward; the wrappers' counters, which each replay advances,
     equal to them; no plain version at all), and one evaluation replayed
     against the eager ladder, the same bits of loss, decoded image and
     gradient. The
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
     the stop-gradded eps-net's, P1-P4 and the plain versions never; evals/s, peak
     memory and useful TFLOP/s; (c) K1 at the latent U-Net's three shapes,
     bf16 and f32, timed beside SDPA and the bound; (d) K2a/K2b/K2c at the
     VQ decoder's sites, eps 1e-6 (K2a/K2b also at the U-Net's, K2a at the
     GroupNorm32 sites), K2b and K2c timed in bf16 and f32, K2c beside the
     F.group_norm + F.silu backward; (e) the
     CLI, --algo hmc_latent, on configs/ffhq_latent.yaml in f32;
  8. the forward operators: (a) every degradation (OPERATOR_DEGS) built at
     256^2 on the card and on the CPU, H, H_pinv, Ht and the input gradient
     of ||y - H(x)||^2 held card against CPU at the CPU tests' tolerances;
     (b) one MH attempt (L = 20) of the flagship (the main path's model,
     bf16, 8 chains) with sr4, deblur_aniso, phase_retrieval and
     deblur_nonlinear, every kernel count set to 0 just before and read
     just after: finite start and end energies, the main path's launches an
     evaluation, the plain versions never; evals/s, peak memory and the
     operator's own loss and gradient time; (c) the bkse KernelWizard at
     its full config, random weights, batch 2 at 256^2, adapt_kernel and
     its input gradient card against CPU in f32 and f64 (the f32 gradient
     reported with the ReLU inputs whose sign rounding flips, the f64 one
     held); (d) the CLI with --deg sr4 on configs/ffhq.yaml;
  9. the rest of the noise-space samplers and solvers, on the main path's
     model and problem, every kernel count set to 0 just before each run
     and read just after (K1, K2a, K2b and K2c launched, every plain
     version never, evals/s and peak memory printed beside the card):
     (a) mass-conditioned HMC, 4 attempts with chain 0 accepting every
     finite proposal, its mass update in [e^-1, e^1]; (b) dual averaging,
     2 rounds, the shared eps checked against the host's recursion on the
     measured acceptance; (c) 2 attempts straight against 1 attempt,
     snapshot, restore into a fresh state and generator and 1 attempt
     (cuDNN deterministic); K1, K2a, K2b and K2c held against their plain
     versions at the site shapes of batch 16 (bf16, f32) and batch 1
     (bf16), and the bf16 input gradient's gap between a batch of 16 and
     two of 8 read with cuDNN deterministic, without cuDNN, with the plain
     versions swapped in, and beside the bf16-f32 distance; (d) 16 chains
     in waves of 8 against one batch of 16 in bf16 and in f32, and
     BASELINE config 4's shape, phase retrieval with 64 chains in waves of
     8; (e) 2 images x 8 chains as one batch against each image alone;
     (f) DMPlug Adam (10 steps) and L-BFGS (3 steps) at batch 1; (g) the
     latent CLI with --checkpoint-dir run twice in this process;
 10. the iterative baselines: (a) all ten (DDNM, DDRM, DPS, PiGDM, DMPS,
     RED-diff, DiffPIR, DAPS, ReSample, the original ReSample) on the tiny
     configs in f32, card against CPU on the same draws (bar
     BASELINE_TOL); (b) each at full width and batch 1 through the port's
     entry points, the eight pixel ones on the main path's model (bf16, 3
     steps), ReSample (11 steps, its 300-step hard consistency at t = 180)
     and the original sampler (20 steps, a pixel and a latent stage) on
     the latent flagship in f32, every kernel count set to 0 just before
     each run and read just after: K1, K2a and K2b launched, K2c exactly
     where the algorithm differentiates a network (DPS, PiGDM, both
     ReSamples), no plain version; wall s, network forwards and backwards,
     peak memory, the branches taken, a finite output; (c) K1 f32 at the
     latent U-Net's batch-1 shapes and K2a, K2b, K2c at its and the VQ
     decoder's batch-1 f32 sites against their plain versions, each timed
     at the U-Net's sites of C = 224 k; (d) the CLIs with --algo dps and
     --algo resample;
 11. the remaining models and utilities: (a) the tiny DDPM, the tiny U-Net
     with a context (transformer_depth 2) and with class labels (forward
     and input gradient) and LPIPS at batch 2, f32, card against CPU (bar
     BASELINE_TOL); (b) the CelebA-HQ DDPM (DDPMConfig's defaults, random
     weights) as the 3-step DDIM decoder's eps-net, 92% random inpainting at
     256^2, 8 chains, one warm-up and DDPM_EVALS energy+grad evaluations in
     bf16 and f32: K2a at every GN+SiLU and GroupNorm32 call, K2b and K2c
     at every GN+SiLU call (forward hooks), K1 and the plain versions never;
     evals/s, peak memory, useful TFLOP/s (utils/profiling.compiled_flops);
     (c) configs/ffhq_latent.yaml's U-Net with context_dim 512 (a
     SpatialTransformer at each attention site) and an (8, 1, 512) context,
     forward and input gradient in f32 and bf16, the same holds; (d) the
     flagship U-Net with 1000 classes, one bf16 energy+grad evaluation
     whose launches are the main path's an evaluation (K1 12); (e)
     LPIPS-VGG at (8, 256, 256, 3) timed, against the CPU at batch 2, and
     the pixel CLI with local random LPIPS weights (its record holds
     lpips); (f) K2a, K2b, K2c against their plain versions at every DDPM
     site shape at eps 1e-6, both dtypes, K2c's picked design timed;
 12. chains over processes (nshmc_tpu_torch/parallel/), two ranks of one
     gloo group (the NSHMC_* contract on localhost) sharing the one card,
     both on cuda:0: (a) the main path's flagship problem, 8 chains as 2
     ranks x 4 through the sharded runner (`chip_smoke.py --mesh-rank DIR`
     is one rank), one attempt with the even chains accepting, against
     the unsharded 8-chain run in this process: decisions equal where
     clear of the bf16 noise, moved states within DISPLACEMENT_TOL of their
     displacement (phase 9(d)'s hold), each rank's K1, K2a, K2b and K2c
     counts set to 0 just before and read just after (each equal to the
     unsharded run's, no plain version), evals/s and peak memory of each rank and of the
     unsharded run; (b) the CLI, --algo hmc --mesh 2 --chains 8 on
     configs/ffhq.yaml, one image: one metrics row, one summary line (the
     primary's), the artifacts once; (c) --algo ddnm over two images, data
     sharded: rank i takes image i, both rows gathered in idx order; (d)
     --algo hmc_latent --mesh 2 --chains 8 on configs/ffhq_latent.yaml.
     Two ranks on one card measure oversubscription, not scaling.
 13. Stable Diffusion 2.1-base (configs/sd21_base_latent.yaml, bf16, seeded
     weights and context, 8 chains at 512^2; `phase_sd`): K1 at its four
     self-attention shapes, K2a and K2b at the U-Net's 2560-channel sites
     (K2a's channel chunks), K2a, K2b and K2c at every KL decoder site
     (512^2 included), each against its plain version; then 4 energy+grad
     evaluations under a device trace, the kernels against the sites and
     against the wrappers' counters.
Every phase that fails ends the run with a nonzero exit code. The last lines
are the kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}. With --trace, one flagship evaluation, one
with each of sr4 and phase_retrieval (and the operator's own loss and
gradient alone), and one latent flagship evaluation in bf16 and in f32 are
profiled (OUT_DIR/trace_main_path.json, trace_operator_sr4.json,
trace_operator_phase_retrieval.json, trace_latent_path.json,
trace_latent_f32_path.json) and nothing else runs.
"""
import contextlib
import dataclasses
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
# each kernel_counters() name's kernel as a device trace names it: (name, CUDA
# C++); a C++ kernel's name carries its template and parameter list, a Triton
# kernel's does not. K2c's two-pass design launches three kernels and P1
# a call (P4 two): a call is counted by one of its kernels.
DEVICE_KERNELS = {"attention": ("attn_fwd_tc_kernel", True),
                  "attention_f32": ("attn_fwd_f32_kernel", True),
                  "gn_stats": ("gn_stats_kernel", True),
                  "gn_stats_triton_chain": ("stats_kernel", False),
                  "gn_apply": ("apply_kernel", False),
                  "gn_backward": ("gn_bwd_fused_kernel", True),
                  "gn_backward_twopass": ("gn_bwd_finish_kernel", True),
                  "probe_stats": ("stats_partial_kernel", True),
                  "probe_apply": ("apply_kernel", True),
                  "probe_touch": ("touch_kernel", True),
                  "probe_mma_stats": ("mma_stats_partial_kernel", True)}


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
def plain_calls():
    """Count the calls of every plain version, each `*_plain` function of
    ops/groupnorm.py and ops/attention.py, while the block runs: on the
    card no path may make one (both modules look them up by name at each
    call, so the counting wrappers see every call that they make)."""
    from nshmc_tpu_torch.ops import attention, groupnorm

    calls = {}
    names = [(m, name) for m in (groupnorm, attention) for name in sorted(vars(m))
             if name.endswith("_plain") and callable(getattr(m, name))]
    originals = {(m, name): getattr(m, name) for m, name in names}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for (m, name), fn in originals.items():
        calls[name] = 0
        setattr(m, name, counting(name, fn))
    try:
        yield calls
    finally:
        for (m, name), fn in originals.items():
            setattr(m, name, fn)


def accepting_draws(engine, generators, like, n_attempts, accept):
    """The engine's own draws (`draw_attempt` on each generator in turn, for
    the chains of `like`), with the accept uniforms of the chains `accept`
    (indices or a slice) set to 0, so that those chains accept every finite
    proposal and move. Passed to a driver as its `draws`."""
    import torch

    for _ in range(n_attempts):
        parts = [engine.draw_attempt(g, like) for g in generators]
        p0, u = torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])
        u[accept] = 0.0
        yield p0, u


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
    design = f" ({attn.bf16_design(t)} design)" if dt == torch.bfloat16 else ""
    print(f"K1 attention {shape} {dname}{design}: {kc.attention_summary(res)}; grad rel "
          f"err {gerr:.2e} (tol {gtol}); device ms per call: kernel {ms:.4f}, plain "
          f"{plain:.4f}, sdpa {lib:.4f} (kernel/sdpa {ms / lib:.2f}), bound {bms:.4f} "
          f"({by}, {100 * bms / ms:.0f}% of it); eager kernel call {eager:.4f} ms")
    check(res["ok"] and gerr <= gtol, f"attention {shape} {dname} disagrees")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                max_abs_err=res["max_abs_err"], tolerance=res["tolerance"], shape=list(shape),
                dtype=dname)


def device_ms(events):
    """The device ms of a profile's `key_averages()`: the sum over the
    kernels' own rows (the operator rows repeat their kernels' time)."""
    from torch.autograd import DeviceType

    dev_time = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)
    return sum(dev_time(e) for e in events if e.device_type == DeviceType.CUDA) / 1e3


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
    events = prof.key_averages()
    busy_us = 1e3 * device_ms(events)
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
    the config's scale_factor and, for a conditional U-Net, the CLI's seeded
    context, 92% random inpainting of a synthetic image, y0 = H(x) + 0.1
    noise, the 3-step DDIM ladder with the stop-grad eps-net, and the
    latent loss."""
    import types

    import yaml
    from nshmc_tpu_torch.cli import host_randn, image_generators
    from nshmc_tpu_torch.cli_latent import latent_configs, load_context
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
                                 dtype=dtype, device=dev, scale_factor=m.get("scale_factor", 1.0))
    ldm.unet.load_state_dict(random_state_dict(torch, ldm.unet, seed))
    ldm.first_stage.load_state_dict(random_state_dict(torch, ldm.first_stage, seed + 1))
    if ldm.conditional:
        ldm.set_context(load_context(cfg, seed, ucfg.context_dim))
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
                                 z_shape=z_shape, z_t=host_randn((CHAINS, *z_shape), host, dev),
                                 op=op, y0=y0, host=host)


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
    no call of a plain version, and the chain checks; returns the
    path's record."""
    from nshmc_tpu_torch.hmc import engine, latent

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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the engine's own draws, but chain 0 accepts; the eps-net ladder replays
    # the decoder's CUDA graphs after its first calls, so the launches are
    # read from a device trace
    with plain_calls() as plain, device_launches(torch) as launches:
        out = latent.run_latent_hmc(p.loss_fn, hcfg, state, p.gen, draws=accepting_draws(
            engine, [p.gen], state.z, hcfg.total_attempts, [0]), callback=timed)
    twopass_parts = launches.pop("gn_backward_twopass_parts")
    wrappers = {k: f.launches for k, f in counters.items()}  # as the replays advance them
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
    print(f"latent path ({dname}) kernel launches on the card (device trace): {launches}; "
          f"GN+SiLU backward calls "
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
    check(not any(plain.values()), f"latent path ({dname}): plain versions ran on the "
                                   f"card: {plain}")
    check(bwd_calls == n_dec_gn * n_evals,
          f"{bwd_calls} GN+SiLU backward calls, {n_dec_gn * n_evals} expected: one per VQ "
          f"decoder site, none in the stop-gradded eps-net")
    for k, v in launches.items():
        check(v == want.get(k, 0), f"latent path ({dname}): kernel {k} launched {v} times, "
                                   f"{want.get(k, 0)} expected")
    check(wrappers == launches and twopass_parts == launches["gn_backward_twopass"],
          f"latent path ({dname}): the wrappers' counters {wrappers} are not the card's "
          f"launches {launches} (two-pass parts {twopass_parts})")
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


def gn_apply_times(torch, gn, x, eps, where="VQ decoder site"):
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
    print(f"K2 apply {tuple(x.shape)} {dname} ({where}): kernel {ms:.4f} ms (CUDA "
          f"graphs; eager {eager:.4f}), plain {plain:.4f}, bound {bms:.4f} ({by}), "
          f"{100 * bms / ms:.0f}% of bound")
    return dict(shape=list(x.shape), dtype=dname, ms=ms, eager_ms=eager, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=None)


def gn_backward_times(torch, gn, kc, shape, dt, design, eps, g, dev, where="VQ decoder site"):
    """K2c's picked design at a site (`where`) in dt: device ms from CUDA
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
    print(f"K2c {design} {shape} {dname} ({where}): kernel {ms:.4f} ms (CUDA graphs), "
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


# ---- 8. the forward operators --------------------------------------------------------------

OPERATOR_DEGS = ("sr4", "sr16", "sr_bicubic4", "inpaint_box", "deblur_gauss", "deblur_aniso",
                 "cs2", "color", "denoise", "hdr", "phase_retrieval", "deblur_nonlinear")
OPERATOR_MH_DEGS = ("sr4", "deblur_aniso", "phase_retrieval", "deblur_nonlinear")
OPERATOR_TRACE_DEGS = ("sr4", "phase_retrieval")
# card against CPU, the CPU tests' tolerances (tests/_torch_operator_parity.py):
# max |card - cpu| <= tol * max |cpu| for the maps; gathers and the HDR clip
# exact, f32 products and the Walsh-Hadamard ladder 1e-5, FFTs 1e-4; every
# input gradient 1e-4; the blur network elementwise atol 2e-4 + rtol 1e-3
OPERATOR_TOL = {"inpaint_box": 0.0, "denoise": 0.0, "hdr": 0.0, "phase_retrieval": 1e-4}
PRODUCT_TOL, GRAD_TOL, NET_ATOL, NET_RTOL = 1e-5, 1e-4, 2e-4, 1e-3


def operator_close(deg, a, b, grad=False):
    """(ok, measured error, what it is held to) for a card result `a`
    against the CPU's `b`."""
    a, b = a.detach().cpu().float(), b.detach().float()
    err = float((a - b).abs().max())
    if deg == "deblur_nonlinear":
        worst = float(((a - b).abs() - NET_RTOL * b.abs()).max())
        return worst <= NET_ATOL, err, f"atol {NET_ATOL} + rtol {NET_RTOL}"
    tol = GRAD_TOL if grad else OPERATOR_TOL.get(deg, PRODUCT_TOL)
    scale = float(b.abs().max())
    return err <= tol * scale, err / max(scale, 1e-30), f"{tol} max|cpu|"


def phase_operators_card_vs_cpu(torch, np, build_operator, d, c):
    """(a) Every degradation built at 256^2 on the card and on the CPU from
    the same numpy seed: H, H_pinv of the CPU's y, Ht where the operator
    has one, and the input gradient of ||y - H(x)||^2 at two chains, the
    card against the CPU. Fails the run on a disagreement."""
    rng = np.random.default_rng(SEED + 6)
    x, x2 = (torch.from_numpy(rng.uniform(-1, 1, (2, c * d * d)).astype(np.float32))
             for _ in range(2))
    rows = []
    for deg in OPERATOR_DEGS:
        ops = {dev: build_operator(deg, c, d, np.random.default_rng(SEED), device=dev)
               for dev in ("cpu", "cuda")}
        res = {}
        for dev, op in ops.items():
            with torch.no_grad():
                y = ops["cpu"].H(x)  # the same measurement on both
                out = {"H": op.H(x.to(dev)), "H_pinv": op.H_pinv(y.to(dev))}
                if hasattr(op, "Ht"):
                    out["Ht"] = op.Ht(y.to(dev))
                target = ops["cpu"].H(x2).to(dev)
            xg = x.detach().clone().to(dev).requires_grad_(True)  # a leaf on each device
            ((target - op.H(xg)) ** 2).sum().backward()
            out["grad"] = xg.grad
            res[dev] = out
        worst = {}
        for name, ref in res["cpu"].items():
            ok, err, held = operator_close(deg, res["cuda"][name], ref, name == "grad")
            check(ok, f"operator {deg} {name}: card vs CPU error {err:.3e}, held to {held}")
            worst[name] = err
        rows.append(f"{deg} {type(ops['cuda']).__name__} " + " ".join(
            f"{k} {v:.1e}" for k, v in worst.items()))
    print("operators at 256^2, card vs CPU (max |err| / max |cpu|; deblur_nonlinear max "
          "|err|), all within the CPU tests' tolerances:\n  " + "\n  ".join(rows))


def operator_problem(torch, np, engine, decode, deg, x_orig, d, c, hcfg):
    """The flagship's HMC problem with degradation `deg`: the operator on
    the card, y0 = H(x) + sigma_0 noise and x_T drawn on the host as the CLI
    draws them, the pixel loss and the chains."""
    from nshmc_tpu_torch.cli import host_randn, image_generators
    from nshmc_tpu_torch.operators import build_operator

    dev = torch.device("cuda")
    op = build_operator(deg, c, d, np.random.default_rng(SEED), device=dev)
    host, gen = image_generators(SEED, dev)
    with torch.no_grad():
        y0 = op.H_img(x_orig)
    y0 = y0 + hcfg.sigma_0 * host_randn(y0.shape, host, dev)
    loss_fn = engine.make_pixel_loss_fn(decode, op, y0[0])
    state = engine.init_chains(hcfg, CHAINS, (d, d, c), dev,
                               x=host_randn((CHAINS, d, d, c), host, dev))
    return op, y0, loss_fn, state, gen


def operator_eval(torch, op, y0, x0):
    """One evaluation's work of the operator alone: ||y0 - H(x0)||^2 and
    its input gradient at the flagship's 8 decoded images (f32)."""
    def run():
        xg = x0.detach().requires_grad_(True)
        torch.autograd.grad(((y0 - op.H_img(xg)) ** 2).sum(), xg)
    return run


def profiled_device_ms(torch, fn):
    """Device ms of one call of fn() (after one untimed) under torch.profiler:
    the sum of its CUDA kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_ms(prof.key_averages())


def phase_operator_attempts(torch, np, engine, gn, decode, counters, main_counts, x_orig, d,
                            c, hcfg):
    """(b) One MH attempt (L = 20, 21 evaluations) at the flagship shape for
    each degradation of OPERATOR_MH_DEGS, every kernel count set to 0 just
    before and read just after: finite start and end energies for every
    chain, the main path's launches an evaluation for every kernel (none
    depends on H), the plain versions never. `main_counts`: (the main
    path's launches, its evaluations). Returns {deg: record}."""
    main_launches, main_evals = main_counts
    evals = hcfg.n_leapfrog + 1
    out = {}
    for deg in OPERATOR_MH_DEGS:
        op, y0, loss_fn, state, gen = operator_problem(torch, np, engine, decode, deg, x_orig,
                                                       d, c, hcfg)
        seen = []

        def recorded(x):
            loss, dec = loss_fn(x)
            seen.append(loss.detach())
            return loss, dec

        for f in (*counters.values(), gn.groupnorm_silu_backward):
            f.launches = 0
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the decoder's first calls run eagerly, then it replays its CUDA
        # graphs: the launches are read from a device trace
        with plain_calls() as plain, device_launches(torch) as launches:
            new, log_ratio = engine.hmc_attempt(recorded, hcfg, state, gen)
        dt = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches.pop("gn_backward_twopass_parts")
        check(launches == {k: f.launches for k, f in counters.items()},
              f"{deg}: the wrappers' counters are not the card's launches {launches}")
        check(len(seen) == evals, f"{deg}: {len(seen)} evaluations, {evals} expected")
        start, end = seen[0], seen[-1]
        check(bool(torch.isfinite(start).all() and torch.isfinite(end).all()
                   and torch.isfinite(log_ratio).all() and torch.isfinite(new.x).all()),
              f"{deg}: energies not finite: start {start.tolist()}, end {end.tolist()}, "
              f"log ratio {log_ratio.tolist()}")
        check(not any(plain.values()), f"{deg}: plain versions ran on the card: {plain}")
        for k, v in launches.items():  # per evaluation, as the inpainting run's
            check(v * main_evals == main_launches[k] * evals,
                  f"{deg}: kernel {k} launched {v / evals} times an evaluation, the main "
                  f"path {main_launches[k] / main_evals}")
        check(gn.groupnorm_silu_backward.launches == launches["gn_backward"]
              + launches["gn_backward_twopass"], f"{deg}: K2c calls and launches disagree")
        with torch.no_grad():
            x0 = decode(state.x)
        op_ms = time_ms(operator_eval(torch, op, y0, x0), iters=10, warmup=2)
        rec = dict(evals_per_s=evals / dt, attempt_s=dt, peak_memory_gb=peak_gb,
                   allocated_before_gb=base_gb,
                   operator_eager_ms=op_ms, launches_per_eval={k: v / evals
                                                               for k, v in launches.items()},
                   data_loss_start=start.tolist(), data_loss_end=end.tolist(),
                   accepted=new.accepted.tolist(), n_leapfrog=hcfg.n_leapfrog, chains=CHAINS,
                   dtype="bfloat16", operator=type(op).__name__)
        print(f"operator {deg} ({type(op).__name__}): 1 MH attempt x {evals} energy+grad evals, "
              f"{CHAINS} chains, bf16: {dt:.3f} s, {rec['evals_per_s']:.3f} evals/s (first "
              f"attempt of this operator), peak memory {peak_gb:.2f} GB ({base_gb:.2f} allocated "
              f"before it); data loss start "
              f"{[round(v, 1) for v in start.tolist()]}, end "
              f"{[round(v, 1) for v in end.tolist()]}, accepted {new.accepted.tolist()}; "
              f"launches an eval equal the main path's "
              f"{ {k: v / evals for k, v in launches.items() if v} }; the operator's loss and "
              f"input gradient alone {op_ms:.3f} ms an evaluation (CUDA events, host included)")
        out[deg] = rec
        del op, y0, loss_fn, state, new, x0
    return out


def trace_operators(torch, np, engine, decode, x_orig, d, c, hcfg, trace_dir):
    """`--trace`: one flagship evaluation with each degradation of
    OPERATOR_TRACE_DEGS under the profiler (device busy ms, a Chrome trace
    OUT_DIR/trace_operator_{deg}.json), and the operator's own device ms an
    evaluation: its loss and input gradient alone, profiled."""
    for deg in OPERATOR_TRACE_DEGS:
        op, y0, loss_fn, state, _ = operator_problem(torch, np, engine, decode, deg, x_orig,
                                                     d, c, hcfg)
        busy = trace_eval(torch, engine, loss_fn, state.x, trace_dir, f"operator_{deg}",
                          f"flagship with {deg}")
        with torch.no_grad():
            x0 = decode(state.x)
        own = profiled_device_ms(torch, operator_eval(torch, op, y0, x0))
        print(f"operator {deg}: device busy {busy:.2f} ms an evaluation, the operator's own "
              f"device time {own:.3f} ms an evaluation ({100 * own / busy:.2f}% of it)")


def kink_signs(torch, net, store):
    """Forward hooks that append, for every input of a ReLU or LeakyReLU of
    `net` (a ResidualBlockNoBN's functional relu: its conv1's output), the
    mask of its positive entries, on the host. Returns the hooks."""
    from nshmc_tpu_torch.models.kernel_wizard import ResidualBlockNoBN

    record = lambda t: store.append((t > 0).cpu())
    hooks = []
    for m in net.modules():
        if isinstance(m, (torch.nn.ReLU, torch.nn.LeakyReLU)):
            hooks.append(m.register_forward_hook(lambda mod, args, out: record(args[0])))
        elif isinstance(m, ResidualBlockNoBN):
            hooks.append(m.conv1.register_forward_hook(lambda mod, args, out: record(out)))
    return hooks


def phase_kernel_wizard(torch, np):
    """(c) The bkse KernelWizard at its full config (nf 64, 10 front and 20
    back resblocks, kernel_dim 512), seeded random weights at the flax
    initialisers' scales, batch 2 at 256^2: adapt_kernel's forward and its
    input gradient (a random cotangent), card against CPU, in f32 and in
    f64 with the same weights. Held: the f32 forward, and the f64 forward
    and gradient, elementwise to atol 2e-4 + rtol 1e-3. The f32 gradient's
    relative L2 error is reported beside the count of ReLU inputs whose sign
    differs between card and CPU: rounding puts some on the other side of
    their kink, and the CPU tests hold the bkse gradient in f64 for that
    reason. Returns the record."""
    from nshmc_tpu_torch.models.kernel_wizard import KernelWizard, KernelWizardConfig
    from nshmc_tpu_torch.operators.nonlinear_blur import init_like_flax

    t0 = time.time()
    cfg = KernelWizardConfig()
    net = KernelWizard(cfg).eval().requires_grad_(False)
    init_like_flax(net, torch.Generator().manual_seed(SEED + 7))
    n_params = sum(p.numel() for p in net.parameters())
    g = torch.Generator().manual_seed(SEED + 8)
    x = torch.rand((2, 3, 256, 256), generator=g)
    k = torch.randn((2, cfg.kernel_dim, 2, 2), generator=g) * 1.2
    w = torch.randn((2, 3, 256, 256), generator=g)

    def run(dev, dtype, signs):
        net.to(device=dev, dtype=dtype)  # f32 -> f64 is exact: the same weights
        xg = x.to(dev, dtype).requires_grad_(True)
        hooks = kink_signs(torch, net, signs)
        try:
            out = net.adapt_kernel(xg, k.to(dev, dtype))
        finally:
            for h in hooks:
                h.remove()
        (grad,) = torch.autograd.grad((out * w.to(dev, dtype)).sum(), xg)
        return out.detach().cpu().double(), grad.cpu().double()

    res, signs = {}, {}
    for dtype in (torch.float32, torch.float64):
        for dev in ("cpu", "cuda"):
            signs[(dev, dtype)] = []
            res[(dev, dtype)] = run(dev, dtype, signs[(dev, dtype)])
    rec = {}
    for dtype in (torch.float32, torch.float64):
        (out_c, g_c), (out_g, g_g) = res[("cpu", dtype)], res[("cuda", dtype)]
        dname = str(dtype).split(".")[1]
        flips = sum(int((a != b).sum()) for a, b in zip(signs[("cpu", dtype)],
                                                        signs[("cuda", dtype)]))
        n_kink = sum(a.numel() for a in signs[("cpu", dtype)])
        fwd_excess = float(((out_g - out_c).abs() - NET_RTOL * out_c.abs()).max())
        grad_excess = float(((g_g - g_c).abs() - NET_RTOL * g_c.abs()).max())
        rec[dname] = dict(forward_max_abs_err=float((out_g - out_c).abs().max()),
                          grad_max_abs_err=float((g_g - g_c).abs().max()),
                          grad_rel_l2=float((g_g - g_c).norm() / g_c.norm()),
                          kink_sign_flips=flips, kink_inputs=n_kink)
        print(f"bkse KernelWizard, full config ({n_params / 1e6:.1f} M parameters), batch 2, "
              f"256^2, {dname}, card vs CPU: adapt_kernel max |err| "
              f"{rec[dname]['forward_max_abs_err']:.2e} (output max |y| "
              f"{float(out_c.abs().max()):.1f}), input gradient max |err| "
              f"{rec[dname]['grad_max_abs_err']:.2e} (max |g| {float(g_c.abs().max()):.2f}), "
              f"relative L2 {rec[dname]['grad_rel_l2']:.2e}; ReLU inputs of other sign on the "
              f"card {flips} of {n_kink}")
        check(fwd_excess <= NET_ATOL and bool(torch.isfinite(out_g).all()),
              f"KernelWizard {dname} forward disagrees with the CPU: {rec[dname]}")
        check(bool(torch.isfinite(g_g).all()), f"KernelWizard {dname} gradient not finite")
        if dtype == torch.float64:
            check(grad_excess <= NET_ATOL, f"KernelWizard f64 input gradient disagrees with "
                                           f"the CPU: {rec[dname]}")
    print(f"bkse KernelWizard phase took {time.time() - t0:.1f} s (held: f32 forward, f64 "
          f"forward and gradient, atol {NET_ATOL} + rtol {NET_RTOL})")
    del net
    return rec


def phase_cli(np, d, deg):
    """The port's pixel CLI end to end on configs/ffhq.yaml with --deg `deg`
    (2 chains, one anneal epoch and one sample): artifacts and the summary
    line. Phase 5 runs inpainting, phase 8(d) sr4."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        from PIL import Image

        Image.fromarray((synthetic_image(np, d, SEED + 3) * 255).astype(np.uint8)).save(
            os.path.join(data, "face.png"))
        cmd = [sys.executable, "-m", "nshmc_tpu_torch.cli", "--config",
               os.path.join(ROOT, "configs", "ffhq.yaml"), "--device", "cuda",
               "--algo", "hmc", "--deg", deg, "--chains", "2", "--tau", "0.1",
               "--epsilon", "0.05", "--hmc_epochs", "1", "--hmc_sampling", "1",
               "--data_path", data, "-i", os.path.join(tmp, "out")]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        check(r.returncode == 0 and lines and lines[-1].startswith('{"summary"'),
              f"CLI --deg {deg} failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n"
              f"{r.stderr[-3000:]}")
        summary = json.loads(lines[-1])["summary"]
        check(math.isfinite(summary.get("psnr", float("nan"))), f"CLI summary {summary}")
        for f in ("0.png", "orig_0.png", "y0_0.png", "std_dev_map_0.png", "metrics.jsonl"):
            check(os.path.exists(os.path.join(tmp, "out", f)), f"CLI --deg {deg} did not write {f}")
        print(f"CLI --deg {deg} (configs/ffhq.yaml, 2 chains, cuda) in {time.time() - t0:.1f} s: "
              f"{lines[-1]}")


# ---- 9. the rest of the noise-space samplers and solvers ---------------------------------------
# (c) resume: decisions, epochs, tau and eps equal; max |dx| within this share of max |x|
# (cuDNN deterministic during (c), the port's kernels deterministic by design)
RESUME_X_TOL = 1e-6
# (d), (e) in bf16: the input gradient at a batch of 16 differs from two batches of 8 by
# up to 11% of its norm, chain by chain (2e-6 in f32). With cuDNN off, the plain versions
# swapped in, or both, it still differs by up to 13-14%, and the bf16 gradient differs
# from the f32 one by up to 16% (`batch_gap_causes`, H100 80GB HBM3, 700 W): any change
# of bf16 rounding moves it that far. 20 leapfrog steps carry that into the states (max
# |dx| 0.65). So a chain's accept decision is compared where |log u - log ratio| exceeds
# a nat, and a moved chain's state by |x_a - x_b| / |x_b - x_T| (L2): 2.5e-3-2.9e-3
# measured (same card), ~1.4 for swapped chains, 1 for a chain that did not move
DECISION_MARGIN = 1.0
DISPLACEMENT_TOL = 0.01
# (d) in f32: every decision equal, max |dx| within this share of max |x| (5.9e-5 to
# 2.1e-4 measured, run to run, H100 80GB HBM3, 700 W)
F32_WAVES_X_TOL = 1e-3
PHASE9_CHAINS = 16   # (d) and (e): 16 chains, as waves of 8 or as 2 images x 8
PR_CHAINS, PR_CHUNK = 64, 8  # BASELINE config 4's shape: phase retrieval, 64 chains in waves of 8
EVEN = slice(None, None, 2)  # (b)-(e): the even chains accept every finite proposal


class Phase9:
    """Phase 9's shared pieces: the flagship model (bf16, 8 chains, L = 20),
    its problem, and `run`, which sets every kernel count to 0 just before
    a run and reads it just after."""

    def __init__(self, torch, np, engine, attn, gn, kc, model, decode, counters, x_orig, d, c,
                 sigma_0, card, f32_decoder):
        self.torch, self.np, self.engine, self.attn, self.gn, self.kc = (
            torch, np, engine, attn, gn, kc)
        self.model, self.decode, self.counters = model, decode, counters
        self.x_orig, self.d, self.c, self.sigma_0, self.card = x_orig, d, c, sigma_0, card
        self.f32_decoder = f32_decoder  # () -> (the flagship U-Net in f32, its decoder)
        self.batch_noise = {}
        self.dev = x_orig.device
        self.sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        self.records = {}

    def problem(self, deg, n_chains, seed=SEED):
        """y0 = H(x) + sigma_0 noise and x_T of `n_chains` drawn on the host from
        generator seed `seed` (as the CLI draws image seed's), the loss and the
        engine's device generator."""
        from nshmc_tpu_torch.cli import host_randn, image_generators
        from nshmc_tpu_torch.operators import build_operator

        op = build_operator(deg, self.c, self.d, self.np.random.default_rng(SEED),
                            device=self.dev)
        host, gen = image_generators(seed, self.dev)
        with self.torch.no_grad():
            y0 = op.H_img(self.x_orig)
        y0 = y0 + self.sigma_0 * host_randn(y0.shape, host, self.dev)
        x = host_randn((n_chains, self.d, self.d, self.c), host, self.dev)
        return op, y0, x, gen

    def run(self, label, fn, evals, k1="attention", root=None):
        """fn() with every count set to 0 just before and read just after: K1
        (`k1`, its bf16 or f32 kernel) launched, K2a, K2b and K2c launched, no
        other kernel and no plain version at all. With `root` (a model whose
        modules the hooks count), K2a once for each GN+SiLU and GroupNorm32
        call, K2b once for each GN+SiLU call and K2c only by a design that
        bwd_design picks at a shape the run saw. `evals`: the run's
        energy+grad evaluations (or solver steps). Returns fn()'s result."""
        torch, gn = self.torch, self.gn
        for f in (*self.counters.values(), gn.groupnorm_silu_backward):
            f.launches = 0
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        box = {}
        # without hooks a decoder replays its CUDA graphs, which no wrapper
        # sees: such a run's launches are read from a device trace
        on_card = device_launches(torch) if root is None else contextlib.nullcontext()
        t0 = time.perf_counter()
        with plain_calls() as plain, on_card as traced:
            if root is not None:
                gn_calls, _, norm_calls = self.kc.count_sites(
                    root, lambda: box.setdefault("out", fn()))
            else:
                box["out"] = fn()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {k: f.launches for k, f in self.counters.items()}
        if traced is not None:
            traced.pop("gn_backward_twopass_parts")
            launches = traced
        k2c = launches["gn_backward"] + launches["gn_backward_twopass"]
        check(not any(plain.values()), f"{label}: plain versions ran on the card: {plain}")
        calls = gn.groupnorm_silu_backward.launches  # channel chunks: several launches a call
        check(launches[k1] > 0 and launches["gn_stats"] > 0 and launches["gn_apply"] > 0
              and k2c >= calls > 0 and (k2c == calls or root is None),
              f"{label}: K1, K2a, K2b and K2c must all launch: {launches}, K2c calls "
              f"{gn.groupnorm_silu_backward.launches}")
        allowed = {k1, "gn_stats", "gn_apply", *BWD_KERNELS.values()}
        if root is not None:
            n_silu, n_norm = sum(gn_calls.values()), sum(norm_calls.values())
            check(launches["gn_stats"] == n_silu + n_norm and launches["gn_apply"] == n_silu,
                  f"{label}: K2a {launches['gn_stats']}, K2b {launches['gn_apply']} launches for "
                  f"{n_silu} GN+SiLU and {n_norm} GroupNorm32 calls")
            allowed = {k1, "gn_stats", "gn_apply",
                       *(BWD_KERNELS[gn.bwd_design(*s_, 4 if k1 == "attention_f32" else 2,
                                                   self.sms)] for s_ in gn_calls)}
        for k, v in launches.items():
            if k not in allowed:
                check(v == 0, f"{label}: kernel {k} launched {v} times, where no shape takes it")
        rec = dict(s=dt, evals=evals, evals_per_s=evals / dt, peak_memory_gb=peak_gb,
                   allocated_before_gb=base_gb, launches=launches, card=self.card)
        self.records[label] = rec
        print(f"phase 9 {label}: {dt:.3f} s, {evals} energy+grad evals (or steps), "
              f"{rec['evals_per_s']:.3f} a second, peak memory {peak_gb:.2f} GB ({base_gb:.2f} "
              f"allocated before); launches { {k: v for k, v in launches.items() if v} }; "
              f"plain versions 0 "
              f"({', '.join(sorted(plain))}); {self.card}")
        return box["out"]


@contextlib.contextmanager
def swapped(*swaps):
    """Each (object, attribute, value) of `swaps` set while the block runs,
    then restored."""
    olds = [(o, name, getattr(o, name)) for o, name, _ in swaps]
    for o, name, value in swaps:
        setattr(o, name, value)
    try:
        yield
    finally:
        for o, name, value in olds:
            setattr(o, name, value)


def plain_swaps(gn, attn):
    """The swaps that put each kernel wrapper's plain version where the
    models call the wrapper: K2a (ops/groupnorm.py and models/nn.py look up
    `group_stats`), K2b, K2c and K1's forward."""
    from nshmc_tpu_torch.models import nn as nn_mod

    return ((gn, "group_stats", gn.group_stats_plain),
            (nn_mod, "group_stats", gn.group_stats_plain),
            (gn, "normalize_silu", gn.normalize_silu_plain),
            (gn, "groupnorm_silu_backward", gn.groupnorm_silu_backward_plain),
            (attn, "attention_forward", attn.attention_plain))


def recording_propose(engine, log):
    """The swap of engine.leapfrog_propose for a copy that records each
    call's (u, log ratio); the drivers return neither."""
    propose = engine.leapfrog_propose

    def wrapped(*args, **kwargs):
        out = propose(*args, **kwargs)
        log.append((kwargs.get("u", args[8] if len(args) > 8 else None), out[4]))
        return out
    return engine, "leapfrog_propose", wrapped


def clear_decisions(torch, log):
    """(u, log ratio) calls -> per chain, whether its accept decision is
    clear of a differently batched run's float noise: |log u - log ratio| >
    DECISION_MARGIN nats."""
    u = torch.cat([a for a, _ in log])
    lr = torch.cat([b for _, b in log])
    return ((torch.log(u) - lr).abs() > DECISION_MARGIN) & torch.isfinite(lr)


def compare_chains(torch, label, a, b, x_start, clear):
    """Accept decisions equal where `clear`; for the moved ones among them
    |x_a - x_b| / |x_b - x_T| (L2, per chain) within DISPLACEMENT_TOL.
    Returns (that ratio's largest value, the count compared)."""
    check(bool(clear.any()), f"{label}: no decision clear of the float noise")
    for name in ("accepted", "epoch"):
        check(torch.equal(getattr(a, name)[clear], getattr(b, name)[clear]),
              f"{label}: {name} {getattr(a, name).tolist()} vs {getattr(b, name).tolist()}")
    moved = clear & (b.accepted > 0)
    check(bool(moved.any()), f"{label}: no clear decision moved a chain")
    ratio = ((a.x - b.x)[moved].flatten(1).norm(dim=1)
             / (b.x - x_start)[moved].flatten(1).norm(dim=1))
    worst = float(ratio.max())
    check(worst <= DISPLACEMENT_TOL, f"{label}: moved states differ by {ratio.tolist()} of "
                                     f"their displacement (tolerance {DISPLACEMENT_TOL})")
    return worst, f"{int(clear.sum())} of {clear.numel()} decisions, {int(moved.sum())} moved"


def apply_check(torch, gn, x, form, g):
    """K2b on plain statistics against normalize_silu_plain, with a seeded
    affine of `form` (per channel or per (batch, channel)): (ok, max abs
    err). Bars: f32 1e-4; bf16 one rounding step, 2^-7 |y| + 1e-3."""
    b, r, cc = x.shape
    mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r)
    shape = (cc,) if form == "per_channel" else (b, cc)
    sc = 1 + 0.3 * torch.randn(shape, generator=g, device=x.device)
    bi = 0.3 * torch.randn(shape, generator=g, device=x.device)
    y_p = gn.normalize_silu_plain(x, mean_c, inv_c, sc, bi).float()
    diff = (gn.normalize_silu(x, mean_c, inv_c, sc, bi).float() - y_p).abs()
    tol = 1e-4 if x.dtype == torch.float32 else 2 ** -7 * y_p.abs() + 1e-3
    return bool((diff <= tol).all()), float(diff.max())


def kernels_at_batches(p):
    """K1, K2a, K2b and K2c held against their plain versions at the site
    shapes of phase 9's runs away from batch 8, at phase 3's bars
    (kernel_check): batch 16 ((d), (e)) in bf16 and in f32 ((d)'s f32 run),
    batch 1 ((f)) in bf16. A decode at that batch, under forward hooks,
    gives the shapes; K2c is called through its wrapper, which picks the
    design (or the channel chunks) by the shape, as the runs call it."""
    import collections

    torch, kc, gn, dev = p.torch, p.kc, p.gn, p.dev
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    for batch, dtypes in ((PHASE9_CHAINS, (torch.bfloat16, torch.float32)),
                          (1, (torch.bfloat16,))):
        with torch.no_grad():
            gn_shapes, attn_shapes, norm_shapes = kc.count_sites(p.model, lambda: p.decode(
                torch.zeros((batch, p.d, p.d, p.c), device=dev)))
        check(all(s_[0] == batch for s_ in [*gn_shapes, *attn_shapes, *norm_shapes]),
              f"batch {batch}: site shapes {gn_shapes}, {attn_shapes}, {norm_shapes}")
        for dt in dtypes:
            dname = str(dt).split(".")[1]
            worst, routes = collections.defaultdict(float), collections.Counter()
            for shape in sorted(attn_shapes):
                res = kc.attention_check(*kc.qkv_inputs(shape, dt, g, dev))
                check(res["ok"], f"phase 9 K1 {shape} {dname}: {kc.attention_summary(res)}")
                worst["K1"] = max(worst["K1"], res["max_abs_err"])
            for shape in sorted({**gn_shapes, **norm_shapes}):
                x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
                res = kc.gn_stats_check(x, gn.NUM_GROUPS, gn.EPS, g)
                check(res["ok"], f"phase 9 K2a {shape} {dname}: {kc.stats_summary(res)}")
                worst["K2a sums rel"] = max(worst["K2a sums rel"], res["sums_rel"])
                worst["GN+SiLU"] = max(worst["GN+SiLU"], res["apply_err"])
            for shape in sorted(gn_shapes):
                x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
                for form in kc.AFFINE_FORMS:
                    ok, err = apply_check(torch, gn, x, form, g)
                    check(ok, f"phase 9 K2b {shape} {dname} {form}: apply max {err:.2e}")
                    worst["K2b"] = max(worst["K2b"], err)
                    res = kc.gn_backward_check(*kc.gn_inputs(shape, dt, form, g, dev))
                    check(res["ok"], f"phase 9 K2c {shape} {dname} {form}: {res}")
                    worst["K2c dx"] = max(worst["K2c dx"], res["dx_err"])
                routes[kc.wrapper_route(shape, dt, p.sms)] += gn_shapes[shape] // 3
            print(f"phase 9 kernels at batch {batch}, {dname}: K1 at {len(attn_shapes)}, K2a at "
                  f"{len(gn_shapes) + len(norm_shapes)}, K2b and K2c (both affine forms) at "
                  f"{len(gn_shapes)} site shapes agree with their plain versions at phase 3's "
                  f"bars, two calls bit-identical; worst {json.dumps(worst)}; K2c's route by "
                  f"sites a U-Net forward {dict(routes)}")


def gradient_gap(p, loss_fn, x):
    """Per chain, |g16 - g8| / |g8| (L2): the input gradient of `loss_fn` at
    one batch of x's chains against the same chains as two half batches."""
    torch, engine = p.torch, p.engine
    half = x.shape[0] // 2
    g16 = engine.value_and_grad(loss_fn, x)[2]
    g8 = torch.cat([engine.value_and_grad(loss_fn, x[a:a + half])[2] for a in (0, half)])
    return ((g16 - g8).flatten(1).norm(dim=1) / g8.flatten(1).norm(dim=1)).tolist()


def batch_gap_causes(p, decode32, x16):
    """What moves the bf16 input gradient between a batch of 16 and two of
    8 (`gradient_gap`): the path as it runs; with cuDNN deterministic; with
    cuDNN off (torch's own convolution, one GEMM an image whatever the
    batch); with the kernels' plain versions swapped in (`plain_swaps`;
    none of the kernels may launch); with both. Beside it the f32 gap and
    the bf16 gradient's own distance from the f32 one at batch 8. Returns
    {setting: per-chain values}."""
    torch, engine, gn = p.torch, p.engine, p.gn
    op, y0, _, _ = p.problem("inpaint_random", 1)
    # both on the eager ladder: a decoder's graphs would not see the plain
    # versions swapped in below, the wrappers count only eager launches, and
    # f32's pool at batch 16 (~55 GB, as the eager peak) would not fit
    loss16 = engine.make_pixel_loss_fn(p.decode.ladder, op, y0[0])
    loss32 = engine.make_pixel_loss_fn(decode32.ladder, op, y0[0])
    no_cudnn = (torch.backends.cudnn, "enabled", False)
    settings = {"kernels, cuDNN": (),
                "kernels, cuDNN deterministic": ((torch.backends.cudnn, "deterministic", True),),
                "kernels, no cuDNN": (no_cudnn,),
                "plain versions, cuDNN": plain_swaps(gn, p.attn),
                "plain versions, no cuDNN": (*plain_swaps(gn, p.attn), no_cudnn)}
    gaps = {}
    for name, swaps in settings.items():
        for f in (*p.counters.values(), gn.groupnorm_silu_backward):
            f.launches = 0
        t0 = time.perf_counter()
        with swapped(*swaps):
            gaps[name] = gradient_gap(p, loss16, x16)
            torch.cuda.synchronize()
        launched = sum(f.launches for f in p.counters.values())
        check(launched == 0 if name.startswith("plain") else launched > 0,
              f"batch gap, {name}: {launched} kernel launches")
        print(f"  (d) bf16 gradient gap, batch 16 against 2 x 8, {name}: "
              f"{min(gaps[name]):.2e}-{max(gaps[name]):.2e} of its norm, "
              f"{sum(v > 0.01 for v in gaps[name])} of {len(gaps[name])} chains over 1% "
              f"({launched} kernel launches, {time.perf_counter() - t0:.1f} s)")
    gaps["float32 kernels, cuDNN"] = gradient_gap(p, loss32, x16)
    g_bf16 = torch.cat([engine.value_and_grad(loss16, x16[a:a + CHAINS])[2] for a in (0, CHAINS)])
    g_f32 = torch.cat([engine.value_and_grad(loss32, x16[a:a + CHAINS])[2] for a in (0, CHAINS)])
    gaps["bf16 against f32, batch 8"] = ((g_bf16 - g_f32).flatten(1).norm(dim=1)
                                         / g_f32.flatten(1).norm(dim=1)).tolist()
    for name in ("float32 kernels, cuDNN", "bf16 against f32, batch 8"):
        print(f"  (d) {name}: {min(gaps[name]):.2e}-{max(gaps[name]):.2e} of the gradient's "
              f"norm, chain by chain")
    print(f"phase 9 gradient gaps by chain: {json.dumps(gaps)}")
    return gaps


def batch_invariance(p, model32, decode32):
    """(d) 16 chains in waves of 8 against one batch of 16, and (e) 2 images x
    8 chains as one batch against each image alone, one attempt each, with
    the even chains accepting. bf16: decisions equal where clear, the moved
    states within DISPLACEMENT_TOL; then (d) in f32: every decision equal,
    max |dx| within F32_WAVES_X_TOL of max |x|."""
    torch, engine = p.torch, p.engine
    shape, evals = (p.d, p.d, p.c), 21
    one = engine.HMCConfig(sigma_0=p.sigma_0, tau=1.0, epsilon=0.05, epochs=1, sampling=1,
                           max_attempts=1)

    def recorded(label, fn, **run_kw):
        log = []
        with swapped(recording_propose(engine, log)):
            out = p.run(label, fn, evals, **run_kw)
        return out, clear_decisions(torch, log)

    def waves(label, decode, chunk, **run_kw):
        gen = torch.Generator(p.dev).manual_seed(SEED + 5)
        return recorded(label, lambda: engine.run_hmc(
            engine.make_pixel_loss_fn(decode, op, y0[0]), one,
            engine.init_chains(one, PHASE9_CHAINS, shape, p.dev, x=x16), gen,
            draws=accepting_draws(engine, [gen], x16, 1, EVEN), chain_chunk=chunk), **run_kw)

    op, y0, x16, _ = p.problem("inpaint_random", PHASE9_CHAINS)
    labels = ["(d) 16 chains, one batch", "(d) 16 chains, waves of 8"]
    (whole, c0), (in_waves, c8) = [waves(label, p.decode, chunk, root=p.model)
                                   for label, chunk in zip(labels, (0, 8))]
    worst, n_clear = compare_chains(torch, "(d)", in_waves, whole, x16, c0 & c8)
    peaks = [p.records[k]["peak_memory_gb"] for k in labels]
    check(peaks[1] < peaks[0], f"(d): waves' peak {peaks[1]} GB not below one batch's {peaks[0]}")
    print(f"  (d) waves of 8 against one batch of 16: {n_clear}, equal; the moved states "
          f"differ by at most {worst:.3e} of their displacement (max |dx| "
          f"{float((in_waves.x - whole.x).abs().max()):.3e}); peak memory {peaks[1]:.2f} GB in "
          f"waves, {peaks[0]:.2f} GB as one batch")
    del whole, in_waves

    probs = [p.problem("inpaint_random", CHAINS, seed=SEED + i) for i in range(2)]
    x_start = torch.cat([q[2] for q in probs])
    state = engine.init_chains(one, 2 * CHAINS, shape, p.dev, x=x_start)
    y0s = torch.cat([q[1] for q in probs])
    builder = lambda y: engine.make_pixel_loss_fn(p.decode, probs[0][0], y)
    gens = [torch.Generator(p.dev).manual_seed(SEED + 20 + i) for i in range(2)]
    multi, clear = recorded("(e) image batch, 2 images x 8 chains", lambda: engine.run_hmc_multi(
        builder, one, state, y0s, gens, draws=accepting_draws(
            engine, gens, state.x[:CHAINS], 1, EVEN)), root=p.model)
    gens = [torch.Generator(p.dev).manual_seed(SEED + 20 + i) for i in range(2)]
    alone = [recorded(f"(e) image {i} alone", lambda: engine.run_hmc(
        builder(y0s[i]), one, engine._chains(state, i * CHAINS, (i + 1) * CHAINS), gens[i],
        draws=accepting_draws(engine, [gens[i]], state.x[:CHAINS], 1, EVEN)), root=p.model)
        for i in range(2)]
    worst, n_clear = compare_chains(torch, "(e)", multi, engine._concat([a for a, _ in alone]),
                                    x_start, clear & torch.cat([c_ for _, c_ in alone]))
    print(f"  (e) each image of the batch against its lone run: {n_clear}, equal; the moved "
          f"states differ by at most {worst:.3e} of their displacement")
    del multi, alone, state

    labels = ["(d) f32, 16 chains, one batch", "(d) f32, 16 chains, waves of 8"]
    (whole, _), (in_waves, _) = [waves(label, decode32, chunk, k1="attention_f32", root=model32)
                                 for label, chunk in zip(labels, (0, 8))]
    for name in ("accepted", "epoch"):
        check(torch.equal(getattr(whole, name), getattr(in_waves, name)),
              f"(d) f32: {name} {getattr(whole, name).tolist()} vs "
              f"{getattr(in_waves, name).tolist()}")
    check(int(whole.accepted.sum()) > 0, "(d) f32: no chain moved")
    dx, x_max = float((in_waves.x - whole.x).abs().max()), float(whole.x.abs().max())
    check(dx <= F32_WAVES_X_TOL * x_max,
          f"(d) f32: max |dx| {dx} > {F32_WAVES_X_TOL} x max |x| {x_max}")
    print(f"  (d) f32, waves of 8 against one batch of 16: every decision equal (accepted "
          f"{whole.accepted.tolist()}), max |dx| {dx:.3e} = {dx / x_max:.2e} of max |x| "
          f"(tolerance {F32_WAVES_X_TOL})")


def phase_noise_space(p, hcfg_main):
    """Phase 9: (a) --algo hmc_cond, (b) --adapt da, (c) snapshot and resume,
    the kernels at batches 16 and 1 and the batch-16 gradient gap, (d) chain
    waves (bf16, f32) and BASELINE config 4's 64 phase-retrieval chains, (e)
    --image_batch, (f) DMPlug Adam and L-BFGS; (g), the latent CLI with
    --checkpoint-dir run twice, is `phase_latent_checkpoint_cli`. Returns
    the runs' records."""
    torch, np, engine = p.torch, p.np, p.engine
    from nshmc_tpu_torch.hmc import adaptation
    from nshmc_tpu_torch.solvers import dmplug

    t_phase = time.time()
    evals = hcfg_main.n_leapfrog + 1
    shape = (p.d, p.d, p.c)

    # (a) mass-conditioned HMC: chain 0 accepts every finite proposal, so its
    # mass update (accepted, epoch > epochs // 3 = 1) fires at attempts 3 and 4
    op, y0, x, gen = p.problem("inpaint_random", CHAINS)
    loss_fn = engine.make_pixel_loss_fn(p.decode, op, y0[0])
    ccfg = adaptation.ConditionedHMCConfig(sigma_0=p.sigma_0, tau=1.0, epsilon=0.05, burn=0,
                                           epochs=3, sampling=1, max_attempts=4)
    state = adaptation.init_conditioned_chains(ccfg, CHAINS, shape, p.dev, x=x)
    out = p.run("(a) hmc_cond", lambda: adaptation.run_conditioned_hmc(
        loss_fn, ccfg, state, gen, draws=accepting_draws(engine, [gen], x, 4, [0])),
        4 * evals, root=p.model)
    m0 = out.mass_diag[0]
    k = ccfg.mass_k
    check(int(out.attempts.min()) == 4 and int(out.accepted[0]) == 4,
          f"(a): attempts {out.attempts.tolist()}, accepted {out.accepted.tolist()}")
    check(bool(torch.isfinite(m0).all()) and float((m0 - 1).abs().max()) > 0.1
          and float(m0.min()) >= math.exp(-k) * (1 - 1e-6)
          and float(m0.max()) <= math.exp(k) * (1 + 1e-6),
          f"(a): chain 0's mass_diag {float(m0.min())}..{float(m0.max())}")
    print(f"  (a) chain 0: accepted {int(out.accepted[0])}, epoch {int(out.epoch[0])}, mass_diag "
          f"in [{float(m0.min()):.4f}, {float(m0.max()):.4f}] (bounds e^-1, e^1), mean "
          f"{float(m0.mean()):.4f}; accepted {out.accepted.tolist()}")
    del out, state

    # (b) dual averaging, 2 rounds, the anneal long enough for every chain; the even
    # chains accept every finite proposal, so the measured acceptance is not 0
    dcfg = engine.HMCConfig(sigma_0=p.sigma_0, tau=1.0, epsilon=0.05, epochs=60, sampling=1,
                            max_attempts=2)
    state = engine.init_chains(dcfg, CHAINS, shape, p.dev, x=x)
    rounds = []
    out, da = p.run("(b) adapt da", lambda: adaptation.run_hmc_dual_averaging(
        loss_fn, dcfg, state, generator=gen, draws=accepting_draws(engine, [gen], x, 2, EVEN),
        callback=lambda s, d_, r: rounds.append((s.accepted.clone(), s.rejected.clone(),
                                                 s.epsilon.clone(), float(d_.log_eps)))),
        2 * evals, root=p.model)
    # the host's recursion, float32 numpy, from the measured acceptance
    f = np.float32
    h_sum, mu, prev_acc = f(0.0), f(math.log(10.0 * 0.05)), torch.zeros_like(state.accepted)
    eps_used, rates = f(np.exp(f(math.log(0.05)))), []
    for t, (acc, rej, eps, dev_log_eps) in enumerate(rounds, 1):
        rates.append(f((acc - prev_acc).sum().item() / CHAINS))
        want = np.where((rej >= 2).cpu().numpy(), f(eps_used * f(0.95)), eps_used)
        check(np.allclose(eps.cpu().numpy(), want, rtol=1e-6),
              f"(b) round {t}: eps {eps.tolist()} not the shared {eps_used}")
        h_sum = f(h_sum + f(f(0.65) - rates[-1]))
        log_eps = f(mu - f(f(np.sqrt(f(t)) / f(0.05)) * h_sum) / f(f(t) + f(10.0)))
        check(abs(float(log_eps) - dev_log_eps) <= 1e-5 * abs(float(log_eps)) + 1e-6,
              f"(b) round {t}: log eps {dev_log_eps} on the card, {float(log_eps)} on the host")
        eps_used, prev_acc = f(np.exp(log_eps)), acc
    print(f"  (b) acceptance by round {[float(r) for r in rates]}, shared eps "
          f"{[float(r[2][0]) for r in rounds]}, next {float(eps_used)}; dual-averaged eps "
          f"{float(torch.exp(da.log_eps_avg)):.5f} after {int(da.t)} rounds (the host's "
          f"recursion agrees)")
    del out, state

    # (c) resume: 2 attempts straight against 1 attempt and its final snapshot (a
    # run whose budget is 1 attempt), then a restore into a fresh state and
    # generator and 1 more attempt; the even chains accept, so the states move
    from nshmc_tpu_torch.utils import checkpointing

    rcfg = engine.HMCConfig(sigma_0=p.sigma_0, tau=1.0, epsilon=0.05, epochs=1, sampling=1,
                            max_attempts=2)
    fresh = lambda: engine.init_chains(rcfg, CHAINS, shape, p.dev, x=x)

    def resume_run(label, attempts, gen_, ck="", ran=None):  # ran: the attempts it runs
        return p.run(label, lambda: engine.run_hmc(
            loss_fn, dataclasses.replace(rcfg, max_attempts=attempts), fresh(), gen_,
            draws=accepting_draws(engine, [gen_], x, attempts, EVEN), checkpoint_dir=ck),
            (ran or attempts) * evals, root=p.model)

    with swapped((torch.backends.cudnn, "deterministic", True)):
        straight = resume_run("(c) resume: 2 attempts straight", 2,
                              torch.Generator(p.dev).manual_seed(SEED + 9))
        with tempfile.TemporaryDirectory() as ck:
            resume_run("(c) resume: 1 attempt + snapshot", 1,
                       torch.Generator(p.dev).manual_seed(SEED + 9), ck)
            saved = checkpointing.load_chain_state(ck, fresh())
            check(saved is not None and int(saved.attempts.max()) == 1, "(c): no snapshot")
            other = torch.Generator(p.dev).manual_seed(SEED + 77)  # the snapshot's state
            resumed = resume_run("(c) resume: restore + 1 attempt", 2, other, ck, ran=1)
    for name in ("accepted", "epoch", "attempts", "rejected"):
        check(torch.equal(getattr(straight, name), getattr(resumed, name)),
              f"(c): {name} {getattr(straight, name).tolist()} vs "
              f"{getattr(resumed, name).tolist()}")
    for name in ("tau", "epsilon"):
        check(torch.equal(getattr(straight, name), getattr(resumed, name)), f"(c): {name} differ")
    check(int(straight.accepted.sum()) > 0, "(c): no chain moved")
    dx = float((straight.x - resumed.x).abs().max())
    check(dx <= RESUME_X_TOL * float(straight.x.abs().max()), f"(c): max |dx| {dx}")
    print(f"  (c) resumed run equals the straight one: accepted {resumed.accepted.tolist()}, "
          f"epochs {resumed.epoch.tolist()}, tau/eps equal, max |dx| {dx} (tolerance "
          f"{RESUME_X_TOL} x max |x|)")
    del straight, resumed, loss_fn

    # (d), (e): the kernels at batches 16 and 1 against their plain versions; what
    # moves the gradient between batch 16 and 2 x 8; then the runs, in bf16 (the main
    # path's readings) and (d) in f32 (the states held)
    kernels_at_batches(p)
    model32, decode32 = p.f32_decoder()
    x16 = p.problem("inpaint_random", PHASE9_CHAINS)[2]
    p.batch_noise = batch_gap_causes(p, decode32, x16)
    batch_invariance(p, model32, decode32)
    del model32, decode32

    one = engine.HMCConfig(sigma_0=p.sigma_0, tau=1.0, epsilon=0.05, epochs=1, sampling=1,
                           max_attempts=1)
    op, y0, x64, gen = p.problem("phase_retrieval", PR_CHAINS)
    loss_fn = engine.make_pixel_loss_fn(p.decode, op, y0[0])
    out = p.run("(d) phase_retrieval, 64 chains in waves of 8", lambda: engine.run_hmc(
        loss_fn, one, engine.init_chains(one, PR_CHAINS, shape, p.dev, x=x64), gen,
        chain_chunk=PR_CHUNK), evals, root=p.model)
    rec = p.records["(d) phase_retrieval, 64 chains in waves of 8"]
    rec["chain_evals_per_s"] = rec["evals_per_s"] * PR_CHAINS
    check(bool(torch.isfinite(out.x).all()) and int(out.attempts.min()) == 1,
          "(d) phase retrieval: state not finite")
    print(f"  (d) BASELINE config 4's shape: {PR_CHAINS} chains, 1 attempt in "
          f"{PR_CHAINS // PR_CHUNK} waves: {rec['chain_evals_per_s']:.2f} chain-evaluations/s, "
          f"accepted {int(out.accepted.sum())} of {PR_CHAINS}")
    del out, loss_fn, x64

    # (f) DMPlug at batch 1: Adam 10 steps, L-BFGS 3 steps
    op, y0, x1, _ = p.problem("inpaint_random", 1)

    def loss_and_decode(x):
        x0 = p.decode(x)
        return torch.sum((y0 - op.H_img(x0)) ** 2), x0

    adam_losses, lbfgs_losses = [], []
    p.run("(f) dmplug_adam, 10 steps", lambda: dmplug.dmplug_adam(
        loss_and_decode, x1, dmplug.DMPlugAdamConfig(max_steps=10),
        progress=lambda k_, l_: adam_losses.append(l_)), 10, root=p.model)  # 10 steps
    p.run("(f) dmplug_lbfgs, 3 steps", lambda: dmplug.dmplug_lbfgs(
        loss_and_decode, x1, epochs=1, max_inner=3, chunk=1,
        progress=lambda k_, l_: lbfgs_losses.append(l_)), 3, root=p.model)
    for name, ls in (("dmplug_adam", adam_losses), ("dmplug_lbfgs", lbfgs_losses)):
        check(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0], f"(f) {name}: losses {ls}")
        p.records[f"(f) {name}, {len(ls)} steps"]["steps_per_s"] = (
            len(ls) / p.records[f"(f) {name}, {len(ls)} steps"]["s"])
    print(f"  (f) dmplug_adam losses {[round(v, 1) for v in adam_losses]}; dmplug_lbfgs losses "
          f"{[round(v, 1) for v in lbfgs_losses]}")
    print(f"phase 9 (a)-(f) took {time.time() - t_phase:.1f} s")
    return p.records


def phase_latent_checkpoint_cli(p):
    """(g) The latent CLI in this process, --algo hmc_latent on
    configs/ffhq_latent.yaml (f32, 2 chains, 3 attempts at L = 2) with
    --checkpoint-dir, twice: the first run launches K1's f32 kernel, K2a,
    K2b and K2c and no plain version; the second restores the final
    snapshot, runs no attempt (K2c 0 launches) and writes the same 0.png
    and summary."""
    from PIL import Image
    from nshmc_tpu_torch import cli

    np = p.np
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        Image.fromarray((synthetic_image(np, 256, SEED + 4) * 255).astype(np.uint8)).save(
            os.path.join(data, "face.png"))
        argv = ["--config", LATENT_CFG, "--device", "cuda", "--algo", "hmc_latent", "--deg",
                "inpaint_random", "--chains", "2", "--tau", "0.1", "--epsilon", "0.05",
                "--latent_epochs", "1", "--latent_sampling", "1", "--data_path", data,
                "--checkpoint-dir", os.path.join(tmp, "ck")]
        first = p.run("(g) latent CLI --checkpoint-dir, run 1", lambda: cli.main(
            argv + ["-i", os.path.join(tmp, "out1")]), 3 * 3, k1="attention_f32")
        check(os.path.exists(os.path.join(tmp, "ck", "img0", "step_0.pt")),
              "(g): no snapshot under img0")
        for f in (*p.counters.values(), p.gn.groupnorm_silu_backward):
            f.launches = 0
        t0 = time.perf_counter()
        with plain_calls() as plain:
            second = cli.main(argv + ["-i", os.path.join(tmp, "out2")])
            p.torch.cuda.synchronize()
        k2c = p.gn.groupnorm_silu_backward.launches
        check(k2c == 0 and not any(plain.values()),
              f"(g) run 2: K2c launched {k2c} times (the run did not restore the final "
              f"snapshot) or plain versions ran: {plain}")
        a = np.asarray(Image.open(os.path.join(tmp, "out1", "0.png")))
        b = np.asarray(Image.open(os.path.join(tmp, "out2", "0.png")))
        check(np.array_equal(a, b) and first == second,
              f"(g): the resumed run's 0.png or summary differs: {first} vs {second}")
        print(f"phase 9 (g) latent CLI --checkpoint-dir, run 2: {time.perf_counter() - t0:.3f} s, "
              f"restored the final snapshot (K2c 0 launches, no attempt), the same 0.png and "
              f"summary {second}; {p.card}")


# ---- 10. the iterative baselines ----------------------------------------------------------------
PIXEL_BASELINES = ("ddnm", "ddrm", "dps", "pigdm", "dmps", "reddiff", "diffpir", "daps")
# the algorithms that differentiate a network (the U-Net, or the VQ decoder in both
# ReSamples), so run K2c; the others differentiate the operator at most
K2C_ALGOS = ("dps", "pigdm", "resample", "resample_original")
# (a) card against CPU on the tiny configs, f32, the same injected draws: max |card - cpu|
# within this share of max |cpu|, the CPU tests' bar for a trajectory through a network
# (tests/_torch_algo_parity.py: each network call within atol 2e-4 + rtol 1e-3, carried
# through the steps). The VQ decoder runs without its quantizer there: the argmin over the
# codebook flips at near ties between card and CPU (phase 7(a)), a step, not a rounding
BASELINE_TOL = 1e-3
TINY_RESAMPLE_INNER = 50  # (a) the tiny hard-consistency solve: 50 steps, not 300
# the new batch-1 f32 K2c sites whose C fits one kernel call (C = 224 k, k = 1-4)
BATCH1_TIMED_C = (224, 448, 672, 896)


class Counted:
    """A network function that counts its forwards, and among them those
    whose input requires grad (each differentiated once by the algorithms)."""

    def __init__(self, fn):
        self.fn, self.forwards, self.backwards = fn, 0, 0

    def __call__(self, *args):
        import torch

        self.forwards += 1
        self.backwards += int(torch.is_grad_enabled() and args[0].requires_grad)
        return self.fn(*args)


@contextlib.contextmanager
def branch_counts():
    """Count the branches the ReSamples take while the block runs: the
    hard-consistency solves and the original sampler's pixel and latent
    stages."""
    from nshmc_tpu_torch.algos import resample
    from nshmc_tpu_torch.sampling import resample_original as ro

    seen = {"hard_consistency": 0, "pixel": 0, "latent": 0}
    hard, stage = resample.ReSample._hard_consistency, ro.travel_stage

    def counting_hard(self, *args):
        seen["hard_consistency"] += 1
        return hard(self, *args)

    def counting_stage(*args):
        out = stage(*args)
        if out:
            seen[out] += 1
        return out

    with swapped((resample.ReSample, "_hard_consistency", counting_hard),
                 (ro, "travel_stage", counting_stage)):
        yield seen


def make_baseline(name, op, decode=None, sigma_0=0.1, **changes):
    """A baseline of the CLIs' choices for inpainting (ReSample with the
    decoder `decode`); `changes` replace its fields."""
    from nshmc_tpu_torch.algos import build_algo
    from nshmc_tpu_torch.algos.resample import ReSample

    algo = (ReSample(operator=op, sigma_0=sigma_0, decode_fn=decode) if name == "resample"
            else build_algo(name, op, sigma_0, "inpaint_random"))
    return dataclasses.replace(algo, **changes)


def run_baseline(torch, name, model_fn, schedule, seq, op, y0, x_t, generator=None, draws=None,
                 decode=None, encode=None, **changes):
    """One baseline through the port's entry points (iterative_sampling,
    run_daps, resample_original_sample); `changes` replace the algorithm's
    or the original sampler's fields."""
    from nshmc_tpu_torch.algos import run_daps
    from nshmc_tpu_torch.sampling import resample_original as ro
    from nshmc_tpu_torch.sampling.loop import iterative_sampling

    if name == "resample_original":
        cfg = ro.ResampleOriginalConfig(**changes)
        return ro.resample_original_sample(model_fn, schedule, decode, encode, op, y0, x_t, cfg,
                                           generator, draws)
    algo = make_baseline(name, op, decode, **changes)
    if name == "daps":
        return run_daps(model_fn, schedule, seq, algo, x_t, y0, generator, draws)
    return iterative_sampling(model_fn, schedule, seq, algo, x_t, y0, generator, draws)


def baseline_draws(torch, name, op, x, steps, **changes):
    """`steps` steps of draws for `name` made on the CPU from a seeded
    generator, in the order the algorithm's `draw` makes them."""
    from nshmc_tpu_torch.algos.base import randn

    g = torch.Generator().manual_seed(SEED + 10)
    if name == "resample_original":
        return [(randn(x.shape, g, x), randn(x.shape, g, x)) for _ in range(steps)]
    algo = make_baseline(name, op, **changes)
    return [algo.draw(g, x) for _ in range(steps)]


def tiny_latent(torch, np, dev):
    """configs/tiny_latent_test.yaml's LDM with seeded random weights on
    `dev` (the same weights on any device)."""
    import yaml
    from nshmc_tpu_torch.cli_latent import latent_configs
    from nshmc_tpu_torch.models.ldm import LatentDiffusion

    with open(LATENT_TINY_CFG) as f:
        cfg = yaml.safe_load(f)
    ucfg, acfg = latent_configs(cfg)
    m = cfg["model"]
    ldm = LatentDiffusion.create(ucfg, acfg, m["linear_start"], m["linear_end"], m["timesteps"],
                                 device="cpu")
    ldm.unet.load_state_dict(random_state_dict(torch, ldm.unet, SEED + 6))
    ldm.first_stage.load_state_dict(random_state_dict(torch, ldm.first_stage, SEED + 7))
    return ldm.to(dev), cfg


def phase_baselines_small(torch, np):
    """(a) The ten baselines on the tiny configs in f32, the card (kernels)
    against the CPU (plain versions), each on the same draws made on the
    CPU: the eight pixel ones through the tiny U-Net (sigma_0 0.1, 3 steps,
    92% random inpainting), ReSample and the original sampler through the
    tiny LDM (6 and 20 steps: its hard consistency and both stages run)."""
    import yaml
    from nshmc_tpu_torch.models import unet
    from nshmc_tpu_torch.operators import build_operator
    from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule

    with open(os.path.join(ROOT, "configs", "tiny_test.yaml")) as f:
        cfg = yaml.safe_load(f)
    mcfg = unet.UNetConfig.from_model_yaml(**cfg["model"])
    model = unet.UNetModel(mcfg)
    model.load_state_dict(random_state_dict(torch, model, SEED + 1))
    d = mcfg.image_size
    x_orig = torch.from_numpy(2 * synthetic_image(np, d, SEED) - 1)[None]
    x_t = torch.randn((1, d, d, 3), generator=torch.Generator().manual_seed(SEED + 9))
    z_t = torch.randn((1, 8, 8, 3), generator=torch.Generator().manual_seed(SEED + 9))
    cases = [(n, 3, {}) for n in PIXEL_BASELINES] + [
        ("resample", 6, dict(inner_steps=TINY_RESAMPLE_INNER)),
        ("resample_original", 20, dict(ddim_steps=20))]
    errs = {}
    for name, steps, changes in cases:
        latent = name.startswith("resample")
        outs, seen = {}, {}
        for dev in ("cpu", "cuda"):  # the draws are made on the CPU, with its operator
            op = build_operator("inpaint_random", 3, d, np.random.default_rng(SEED), device=dev)
            x = (z_t if latent else x_t).to(dev)
            if dev == "cpu":
                draws = baseline_draws(torch, name, op, x, steps,
                                       **({} if name == "resample_original" else changes))
            if latent:
                ldm, lcfg = tiny_latent(torch, np, dev)
                sched, seq = ldm.schedule, DDIMSequence.create(lcfg["model"]["timesteps"], 5)
                fn = ldm.model_fn(stop_gradient=name == "resample_original")
                kw = dict(decode=lambda z, ldm=ldm: ldm.decode_first_stage(z, True),
                          encode=ldm.encode_first_stage)
            else:
                sched, seq, fn, kw = (DiffusionSchedule.create(device=dev),
                                      DDIMSequence.create(1000, 3), model.to(dev), {})
            with branch_counts() as br:
                out = run_baseline(torch, name, fn, sched, seq, op, op.H_img(x_orig.to(dev)), x,
                                   draws=[tuple(t.to(dev) for t in s_) for s_ in draws],
                                   **kw, **changes)
            outs[dev], seen[dev] = out.detach().cpu(), dict(br)
        ref = outs["cpu"]
        errs[name] = float((outs["cuda"] - ref).abs().max() / ref.abs().max())
        check(bool(torch.isfinite(ref).all()) and errs[name] <= BASELINE_TOL
              and seen["cpu"] == seen["cuda"],
              f"phase 10(a) {name}: card vs CPU {errs[name]:.2e} (bar {BASELINE_TOL}), "
              f"branches {seen}")
        if name == "resample":
            check(seen["cuda"]["hard_consistency"] == 1, f"(a) ReSample branches {seen}")
        if name == "resample_original":
            check(seen["cuda"]["pixel"] == seen["cuda"]["latent"] == 1,
                  f"(a) original ReSample branches {seen}")
    print(f"phase 10(a) the ten baselines on the tiny configs, f32, card vs CPU on the same "
          f"draws: max|card - cpu| / max|cpu| {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} "
          f"(bar {BASELINE_TOL}); ReSample's hard consistency and both stages of the original "
          f"sampler ran on both")
    return errs


def baseline_run(torch, gn, counters, card, label, fn, k1, k2c, nets):
    """fn() with every kernel count set to 0 just before and read just
    after: K1 (`k1`, its bf16 or f32 kernel), K2a and K2b launched, K2c
    launched exactly when `k2c`, no other kernel and no plain version. Each
    of `nets` (Counted) counts its forwards and backwards. Prints one line
    and returns its record."""
    for f in (*counters.values(), gn.groupnorm_silu_backward):
        f.launches = 0
    for n in nets.values():
        n.forwards = n.backwards = 0
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_calls() as plain, branch_counts() as branches:
        out = fn()
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: f.launches for k, f in counters.items()}
    k2c_n = launches["gn_backward"] + launches["gn_backward_twopass"]
    finite = bool(torch.isfinite(out).all())
    check(not any(plain.values()), f"{label}: plain versions ran on the card: {plain}")
    check(finite, f"{label}: the output is not finite")
    check(launches[k1] > 0 and launches["gn_stats"] > 0 and launches["gn_apply"] > 0
          and (k2c_n > 0) == k2c,
          f"{label}: K1 ({k1}), K2a, K2b must launch and K2c {'must' if k2c else 'must not'}: "
          f"{launches}")
    allowed = {k1, "gn_stats", "gn_apply", *(BWD_KERNELS.values() if k2c else ())}
    for k, v in launches.items():
        check(k in allowed or v == 0, f"{label}: kernel {k} launched {v} times")
    rec = dict(s=dt, peak_memory_gb=peak_gb, allocated_before_gb=base_gb,
               launches={k: v for k, v in launches.items() if v},
               **{f"{k}_{w}": getattr(n, w) for k, n in nets.items()
                  for w in ("forwards", "backwards")},
               branches={k: v for k, v in branches.items() if v}, finite=finite, card=card)
    print(f"phase 10(b) {label}: {dt:.3f} s, "
          + ", ".join(f"{k} forwards {n.forwards} backwards {n.backwards}"
                      for k, n in nets.items())
          + f", peak memory {peak_gb:.2f} GB ({base_gb:.2f} allocated before); launches "
          f"{rec['launches']}; plain versions 0; output finite; branches "
          f"{rec['branches'] or 'the plain ladder'}; {card}")
    rec["launches"] = launches
    return rec


def phase_baselines(torch, np, gn, counters, card, flagship):
    """(b) The ten baselines at full width, batch 1: the eight pixel ones
    on the flagship model (configs/ffhq.yaml, bf16, the main path's random
    weights, 92% random inpainting, sigma_0 0.1, 3 steps), ReSample on the
    latent flagship (configs/ffhq_latent.yaml, f32, 11 steps 990 ... 90:
    the 300-step hard consistency at t = 180) and the original sampler (20
    DDIM steps: a pixel stage at index 10, a latent one at index 5), the
    latent runs under torch's default TF32 settings as the CLI runs. y0's
    noise and x_T from the host generator, the step draws from the device
    generator, as the CLIs draw them. Returns {label: record}."""
    from nshmc_tpu_torch.cli import host_randn, image_generators
    from nshmc_tpu_torch.schedules import DDIMSequence

    dev = torch.device("cuda")
    f = flagship
    recs = {}
    host, gen = image_generators(SEED + 20, dev)
    y0 = f.op.H_img(f.x_orig)
    y0 = y0 + f.sigma_0 * host_randn(y0.shape, host, dev)
    x_t = host_randn((1, f.d, f.d, f.c), host, dev)
    for name in PIXEL_BASELINES:
        net = Counted(f.model)
        recs[name] = baseline_run(
            torch, gn, counters, card, name,
            lambda: run_baseline(torch, name, net, f.sched, f.seq, f.op, y0, x_t, gen),
            "attention", name in K2C_ALGOS, {"unet": net})
    with swapped((torch.backends.cudnn, "allow_tf32", True)):
        p = latent_problem(torch, np, LATENT_CFG, torch.float32, dev)
        z_t = host_randn((1, *p.z_shape), p.host, dev)
        for name in ("resample", "resample_original"):
            net = Counted(p.ldm.model_fn(stop_gradient=name == "resample_original"))
            dec = Counted(p.ldm.decode_first_stage)
            seq = DDIMSequence.create(p.ldm.schedule.num_timesteps, 10)
            kw = {} if name == "resample" else dict(ddim_steps=20)
            recs[name] = baseline_run(
                torch, gn, counters, card, name,
                lambda: run_baseline(torch, name, net, p.ldm.schedule, seq, p.op, p.y0[:1], z_t,
                                     p.gen, decode=dec, encode=p.ldm.encode_first_stage, **kw),
                "attention_f32", True, {"unet": net, "decoder": dec})
        want = {"resample": {"hard_consistency": 1}, "resample_original": {"pixel": 1, "latent": 1}}
        for name, w in want.items():
            check(recs[name]["branches"] == w, f"{name}: branches {recs[name]['branches']}, "
                                               f"expected {w}")
    del p
    return recs


def gn_stats_times(torch, gn, x, eps, where):
    """K2a's launch at x (B, R, C): device ms from CUDA graphs beside its
    plain version's and `torch.var_mean`'s (per channel, no group
    combine), and the bound."""
    b, r, cc = x.shape
    n = b * r * cc
    ms = time_ms_graph(lambda: gn.group_stats(x, gn.NUM_GROUPS, eps))
    plain = time_ms_graph(lambda: gn.group_stats_plain(x, gn.NUM_GROUPS, eps))
    lib = time_ms_graph(lambda: torch.var_mean(x, dim=1, correction=0))
    bms, by = bound_ms(n * x.element_size() + b * 4 * cc * 4, 3 * n, "float32")
    dname = str(x.dtype).split(".")[1]
    print(f"K2a {tuple(x.shape)} {dname} ({where}): kernel {ms:.4f} ms (CUDA graphs), plain "
          f"{plain:.4f}, var_mean {lib:.4f}, bound {bms:.4f} ({by}), {100 * bms / ms:.0f}% of "
          f"bound")
    return dict(shape=list(x.shape), dtype=dname, eps=eps, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


def phase_baselines_kernels(torch, attn, gn, kc):
    """(c) The new shapes of (b), kernel against plain: K1 f32 at the latent
    U-Net's batch-1 shapes (timed beside SDPA and the bound), and K2a, K2b
    and K2c at every batch-1 f32 site of the latent U-Net and the VQ
    decoder (K2c: each design that can take the call and the wrapper, which
    cuts C > 1024 into channel chunks), at phase 3's bars; K2c's picked
    design timed at the latent U-Net's sites of C = 224 k (k = 1-4) beside
    the F.group_norm + F.silu backward and the bound, K2a and K2b timed
    there too. Returns {kernel: [records]}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"attention_f32": [], "gn_stats": [], "gn_apply": [], "gn_backward": [],
           "gn_backward_twopass": []}
    for shape in kc.BATCH1_ATTN_SHAPES:
        out["attention_f32"].append(attention_case(torch, attn, kc, shape, torch.float32, g, dev))
    dt, n_sites = torch.float32, 0
    for part, (eps, sites) in kc.BATCH1_GN_SITES.items():
        for shape in sites:
            x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
            st = kc.gn_stats_check(x, gn.NUM_GROUPS, eps, g)
            check(st["ok"], f"(c) K2a {part} {shape} eps {eps:g}: {kc.stats_summary(st)}")
            for form in kc.AFFINE_FORMS:
                ok, err = apply_check(torch, gn, x, form, g)
                check(ok, f"(c) K2b {part} {shape} {form}: apply max {err:.2e}")
                inputs = kc.gn_inputs(shape, dt, form, g, dev, eps)
                for design in (*gn.bwd_designs(*shape, dt.itemsize, sms), None):
                    res = kc.gn_backward_check(*inputs, design=design)
                    check(res["ok"], f"(c) K2c {design or 'wrapper'} {part} {shape} {form}: "
                                     f"{res}")
            n_sites += 1
            if part == "latent_unet" and shape[2] in BATCH1_TIMED_C:
                where, n = "latent U-Net site, batch 1", {"sites": sites[shape]}
                out["gn_stats"].append({**gn_stats_times(torch, gn, x, eps, where), **n})
                out["gn_apply"].append({**gn_apply_times(torch, gn, x, eps, where), **n})
                design = gn.bwd_design(*shape, dt.itemsize, sms)
                rec = gn_backward_times(torch, gn, kc, shape, dt, design, eps, g, dev, where)
                out[BWD_KERNELS[design]].append({**rec, **n})
    print(f"phase 10(c) K1 f32 at {len(kc.BATCH1_ATTN_SHAPES)} batch-1 shapes, K2a, K2b and K2c "
          f"(each design that takes the call and the wrapper, both affine forms) at {n_sites} "
          f"batch-1 f32 sites agree with their plain versions at phase 3's bars")
    return out


def phase_baseline_cli(np, cfg, algo, size):
    """(d) The port's CLI, --algo `algo` on `cfg` on one synthetic image:
    {idx}.png, metrics.jsonl and the summary line."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        from PIL import Image

        Image.fromarray((synthetic_image(np, size, SEED + 5) * 255).astype(np.uint8)).save(
            os.path.join(data, "face.png"))
        cmd = [sys.executable, "-m", "nshmc_tpu_torch.cli", "--config", cfg, "--device", "cuda",
               "--algo", algo, "--deg", "inpaint_random", "--data_path", data,
               "-i", os.path.join(tmp, "out")]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        check(r.returncode == 0 and lines and lines[-1].startswith('{"summary"'),
              f"CLI --algo {algo} failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n"
              f"{r.stderr[-3000:]}")
        summary = json.loads(lines[-1])["summary"]
        check(math.isfinite(summary.get("psnr", float("nan"))), f"CLI summary {summary}")
        for name in ("0.png", "orig_0.png", "y0_0.png", "metrics.jsonl"):
            check(os.path.exists(os.path.join(tmp, "out", name)),
                  f"CLI --algo {algo} did not write {name}")
        print(f"phase 10(d) CLI --algo {algo} ({os.path.basename(cfg)}, cuda) in "
              f"{time.time() - t0:.1f} s: {lines[-1]}")


# ---- 11. the remaining models and utilities ---------------------------------------------------
# (a) the tiny DDPM of tests/test_torch_ddpm_simple.py; each model card against CPU within
# phase 10(a)'s bar (BASELINE_TOL of max|cpu|), LPIPS too
DDPM_TINY = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                 in_channels=3, resolution=16)
DDPM_EVALS = 3         # (b) timed energy+grad evaluations, after one warm-up
COND_CONTEXT_DIM = 512  # (c) one (8, 1, 512) token: a class-embedding conditioner's shape
N_CLASSES = 1000        # (d) the class-conditional ADM's label count (class_cond: true)


def lpips_weights(torch, seed):
    """Seeded random weights in torchvision's VGG16 `features.*` layout (He
    scaled) and lpips' `lin{i}.model.1` heads (non-negative, as trained
    heads are)."""
    from nshmc_tpu_torch.utils import lpips

    g = torch.Generator().manual_seed(seed)
    vgg_sd, in_ch = {}, 3
    chans = [ch for ch, n in lpips._VGG_STAGES for _ in range(n)]
    for idx, out_ch in zip(lpips.TV_CONV_IDX, chans):
        vgg_sd[f"features.{idx}.weight"] = (torch.randn(out_ch, in_ch, 3, 3, generator=g)
                                            * math.sqrt(2.0 / (9 * in_ch)))
        vgg_sd[f"features.{idx}.bias"] = 0.05 * torch.randn(out_ch, generator=g)
        in_ch = out_ch
    lin_sd = {f"lin{i}.model.1.weight": torch.rand(1, ch, 1, 1, generator=g)
              for i, (ch, _) in enumerate(lpips._VGG_STAGES)}
    return vgg_sd, lin_sd


def lpips_model(torch, seed):
    from nshmc_tpu_torch.utils import lpips

    m = lpips.LPIPS()
    m.load_state_dict(lpips.port_lpips_weights(*lpips_weights(torch, seed)), strict=True)
    return m.eval()


def phase_models_small(torch, np):
    """(a) Card (kernels) against CPU (plain versions), f32, on tiny
    configs: the tiny DDPM, the tiny U-Net with context_dim 24 and
    transformer_depth 2 (a 5-token context, so a site without it would
    differ), and with 10 classes, each its output and the input gradient
    of sum(eps^2); LPIPS at batch 2, 64^2. Returns {case: errors}."""
    import yaml
    from nshmc_tpu_torch.models import ddpm_simple, unet

    with open(os.path.join(ROOT, "configs", "tiny_test.yaml")) as f:
        base = unet.UNetConfig.from_model_yaml(**yaml.safe_load(f)["model"])
    g = torch.Generator().manual_seed(SEED + 50)
    x = torch.randn((2, 16, 16, 3), generator=g)
    t = torch.tensor([100.0, 700.0])
    cases = {"ddpm": (ddpm_simple.DDPMModel(ddpm_simple.DDPMConfig(**DDPM_TINY)), {}),
             "conditional": (unet.UNetModel(dataclasses.replace(
                 base, context_dim=24, transformer_depth=2)),
                 {"context": torch.randn((2, 5, 24), generator=g)}),
             "class_conditional": (unet.UNetModel(dataclasses.replace(base, num_classes=10)),
                                   {"y": torch.tensor([3, 7])})}
    errs = {}
    for i, (name, (model, kw)) in enumerate(cases.items()):
        model.load_state_dict(random_state_dict(torch, model, SEED + 51 + i))
        outs = {}
        for dev in ("cpu", "cuda"):
            m = model.to(dev)
            xx = x.to(dev).requires_grad_(True)
            out = m(xx, t.to(dev), **{k: v.to(dev) for k, v in kw.items()})
            (gr,) = torch.autograd.grad((out[..., :3] ** 2).sum(), xx)
            outs[dev] = (out.detach().cpu(), gr.cpu())
        e = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(outs["cuda"], outs["cpu"])]
        errs[name] = {"forward": e[0], "input_gradient": e[1]}
        check(max(e) <= BASELINE_TOL and all(bool(torch.isfinite(v).all()) for v in outs["cpu"]),
              f"phase 11(a) {name}: card vs CPU {e} (bar {BASELINE_TOL})")
    lp = lpips_model(torch, SEED + 54)
    a, b = (torch.rand((2, 64, 64, 3), generator=g) * 2 - 1 for _ in range(2))
    vals = {dev: lp.to(dev)(a.to(dev), b.to(dev)).cpu() for dev in ("cpu", "cuda")}
    errs["lpips"] = float((vals["cuda"] - vals["cpu"]).abs().max() / vals["cpu"].abs().max())
    check(errs["lpips"] <= BASELINE_TOL, f"phase 11(a) LPIPS: card vs CPU {errs['lpips']:.2e}")
    print(f"phase 11(a) tiny DDPM, conditional U-Net (context, depth 2), class-conditional U-Net "
          f"(forward, input gradient) and LPIPS (batch 2, 64^2), f32, card vs CPU: "
          f"max|card - cpu| / max|cpu| {json.dumps(errs)} (bar {BASELINE_TOL})")
    return errs


def counted_run(torch, kc, gn, counters, root, fn, n, label):
    """fn() `n` times with every kernel count set to 0 just before and read
    just after, the plain versions and the GN sites under `root` counted
    (forward hooks): (record, launches, {GN+SiLU shape: calls}, {GroupNorm32
    shape: calls}, {attention shape: calls}). Checks no plain version ran."""
    for f in (*counters.values(), gn.groupnorm_silu_backward):
        f.launches = 0
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_calls() as plain:
        gn_calls, attn_calls, norm_calls = kc.count_sites(root, lambda: [fn() for _ in range(n)])
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    launches["gn_backward_calls"] = gn.groupnorm_silu_backward.launches
    check(not any(plain.values()), f"{label}: plain versions ran on the card: {plain}")
    rec = dict(s=dt, runs=n, per_s=n / dt, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               allocated_before_gb=base_gb)
    return rec, launches, gn_calls, norm_calls, attn_calls


def check_gn_launches(label, gn, launches, gn_calls, norm_calls, itemsize, k1_calls=0):
    """K2a at every GN+SiLU and GroupNorm32 call, K2b at every GN+SiLU call,
    K2c at every GN+SiLU call (each differentiated once: no remat on these
    paths; a call too wide for one kernel call, an f32 C > 1024, as its
    channel chunks, each a call of its own) and launched; K1 `k1_calls`
    times (a SpatialTransformer's self-attention), nothing else."""
    n_silu, n_norm = sum(gn_calls.values()), sum(norm_calls.values())
    k2c = launches["gn_backward"] + launches["gn_backward_twopass"]
    calls = sum(n * gn.bwd_channel_chunks(c, gn.NUM_GROUPS, itemsize)
                for (_, _, c), n in gn_calls.items())
    check(launches["gn_stats"] == n_silu + n_norm and launches["gn_apply"] == n_silu
          and launches["gn_backward_calls"] == calls == k2c and n_silu > 0,
          f"{label}: K2a {launches['gn_stats']}, K2b {launches['gn_apply']}, K2c calls "
          f"{launches['gn_backward_calls']} ({k2c} launches, {calls} expected) for {n_silu} "
          f"GN+SiLU and {n_norm} GroupNorm32 calls")
    check(launches["attention"] + launches["attention_f32"] == k1_calls,
          f"{label}: K1 launched {launches['attention']} + {launches['attention_f32']} times, "
          f"not {k1_calls}")
    allowed = {"gn_stats", "gn_apply", "gn_backward", "gn_backward_twopass", "gn_backward_calls",
               "attention", "attention_f32"}
    for k, v in launches.items():
        check(k in allowed or v == 0, f"{label}: kernel {k} launched {v} times")


def phase_ddpm(torch, np, engine, kc, gn, counters, card):
    """(b) The CelebA-HQ DDPM (DDPMConfig's defaults, random weights from
    seed 0) as the eps-net of the 3-step DDIM decoder, 92% random
    inpainting at 256^2, 8 chains: one warm-up energy+grad evaluation (its
    FLOPs counted by utils/profiling.compiled_flops) and DDPM_EVALS timed
    ones, in bf16 and f32, each timed run's counts set to 0 just before and
    read just after. Returns {dtype: record}."""
    from nshmc_tpu_torch.cli import host_randn, image_generators
    from nshmc_tpu_torch.models.ddpm_simple import DDPMConfig, DDPMModel
    from nshmc_tpu_torch.operators import build_operator
    from nshmc_tpu_torch.sampling import ddim
    from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
    from nshmc_tpu_torch.utils.profiling import compiled_flops

    dev = torch.device("cuda")
    cfg = DDPMConfig()
    d = cfg.resolution
    op = build_operator("inpaint_random", 3, d, np.random.default_rng(SEED), device=dev)
    host, _ = image_generators(SEED + 60, dev)
    y0 = op.H_img(2 * torch.from_numpy(synthetic_image(np, d, SEED + 60)).to(dev)[None] - 1)
    y0 = y0 + 0.1 * host_randn(y0.shape, host, dev)
    x = host_randn((CHAINS, d, d, 3), host, dev)
    sched, seq = DiffusionSchedule.create(device=dev), DDIMSequence.create(1000, 3)
    weights, out = None, {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[1]
        model = DDPMModel(cfg, dtype=dt)
        weights = weights or random_state_dict(torch, model, SEED)
        model.load_state_dict(weights)
        model = model.to(dev).eval()
        loss_fn = engine.make_pixel_loss_fn(ddim.make_decoder(model, sched, seq), op, y0[0])
        res = {}
        flops = compiled_flops(lambda: res.setdefault("w", engine.value_and_grad(loss_fn, x)))
        loss, dec, grad = res["w"]
        check(bool(torch.isfinite(loss).all() and torch.isfinite(grad).all())
              and dec.shape == (CHAINS, d, d, 3) and float(grad.abs().max()) > 0,
              f"phase 11(b) DDPM {dname}: loss or gradient not finite, or zero")
        label = f"phase 11(b) DDPM {dname}"
        rec, launches, gn_calls, norm_calls, _ = counted_run(
            torch, kc, gn, counters, model, lambda: engine.value_and_grad(loss_fn, x),
            DDPM_EVALS, label)
        check_gn_launches(label, gn, launches, gn_calls, norm_calls, dt.itemsize)
        per = {k: v / DDPM_EVALS for k, v in launches.items() if v}
        check(sum(gn_calls.values()) == 3 * DDPM_EVALS * sum(kc.DDPM_GN_SITES.values())
              and sum(norm_calls.values()) == 3 * DDPM_EVALS * sum(kc.DDPM_NORM_SITES.values()),
              f"{label}: {sum(gn_calls.values())} GN+SiLU and {sum(norm_calls.values())} "
              f"GroupNorm32 calls for {DDPM_EVALS} evaluations of 3 forwards")
        rec.update(evals_per_s=rec["per_s"], useful_tflop_per_eval=flops / 1e12,
                   useful_tflop_per_s=flops * rec["per_s"] / 1e12, launches_per_eval=per,
                   loss=loss.tolist(), dtype=dname, chains=CHAINS, card=card)
        print(f"{label}: {DDPM_EVALS} energy+grad evals (3 DDPM forwards and their input "
              f"gradient each), {CHAINS} chains, 256^2: {rec['s']:.3f} s, "
              f"{rec['evals_per_s']:.3f} evals/s, peak memory {rec['peak_memory_gb']:.2f} GB "
              f"({rec['allocated_before_gb']:.2f} allocated before), "
              f"{flops / 1e12:.3f} TFLOP an eval (utils/profiling.compiled_flops), "
              f"{rec['useful_tflop_per_s']:.1f} useful TFLOP/s; launches an eval {per}; "
              f"plain versions 0, K1 0; {card}")
        rec["launches"] = launches
        out[dname] = rec
        del model, loss_fn, res, loss, dec, grad
    return out


def phase_conditional(torch, kc, gn, counters, card):
    """(c) configs/ffhq_latent.yaml's latent U-Net with context_dim 512,
    transformer_depth 1 (SpatialTransformers at its 16 attention sites),
    random weights, 8 chains at 64^2 and a random (8, 1, 512) context: a
    warm-up, then one forward and the input gradient of sum(eps^2) counted
    (K1 at each site's self-attention), in f32 and bf16. Returns {dtype:
    record}."""
    from nshmc_tpu_torch.models.ldm import latent_unet_config
    from nshmc_tpu_torch.models.unet import UNetModel

    dev = torch.device("cuda")
    cfg = dataclasses.replace(latent_unet_config(), context_dim=COND_CONTEXT_DIM,
                              transformer_depth=1)
    g = torch.Generator(device=dev).manual_seed(SEED + 70)
    x = torch.randn((CHAINS, cfg.image_size, cfg.image_size, 3), generator=g, device=dev)
    t = torch.full((CHAINS,), 500.0, device=dev)
    ctx = torch.randn((CHAINS, 1, COND_CONTEXT_DIM), generator=g, device=dev)
    weights, out = None, {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        model = UNetModel(cfg, dtype=dt)
        weights = weights or random_state_dict(torch, model, SEED + 71)
        model.load_state_dict(weights)
        model = model.to(dev).eval()

        def fwd_grad():
            xx = x.detach().requires_grad_(True)
            eps = model(xx, t, context=ctx)
            return eps, torch.autograd.grad((eps ** 2).sum(), xx)[0]

        eps, grad = fwd_grad()
        check(bool(torch.isfinite(eps).all() and torch.isfinite(grad).all())
              and float(grad.abs().max()) > 0, f"phase 11(c) {dname}: not finite, or zero")
        label = f"phase 11(c) conditional U-Net {dname}"
        rec, launches, gn_calls, norm_calls, attn_calls = counted_run(
            torch, kc, gn, counters, model, fwd_grad, 1, label)
        self_attn = sum(name.endswith(".attn1") for name, _ in model.named_modules())
        check_gn_launches(label, gn, launches, gn_calls, norm_calls, dt.itemsize, self_attn)
        check(norm_calls == kc.COND_UNET_NORM_SITES and not attn_calls
              and gn_calls == kc.LATENT_UNET_GN_SITES,
              f"{label}: GroupNorm32 sites {norm_calls}, GN+SiLU {gn_calls}, attention "
              f"blocks {attn_calls}")
        rec.update(ms=1e3 * rec["s"], launches_nonzero={k: v for k, v in launches.items() if v},
                   dtype=dname, chains=CHAINS, card=card)
        print(f"{label}: forward + input gradient, {CHAINS} chains, (8, 1, 512) context: "
              f"{rec['ms']:.1f} ms, peak memory {rec['peak_memory_gb']:.2f} GB; launches "
              f"{rec['launches_nonzero']} (K2a at the 16 SpatialTransformer norms too; K1 at "
              f"their {self_attn} self-attentions); plain versions 0; {card}")
        rec["launches"] = launches
        out[dname] = rec
        del model, eps, grad
    return out


def phase_class_conditional(torch, np, engine, gn, kc, counters, main_counts, mcfg, sched, seq,
                            op, y0, card):
    """(d) configs/ffhq.yaml's U-Net with num_classes 1000 (label_emb),
    random weights and labels, bf16, 8 chains: a warm-up energy+grad
    evaluation through the 3-step decoder and one counted, whose launches
    must be the main path's an evaluation (K1 12, K2a, K2b, K2c as phase
    2). Returns its record."""
    from nshmc_tpu_torch.models.unet import UNetModel
    from nshmc_tpu_torch.sampling import ddim

    dev = torch.device("cuda")
    main_launches, main_evals = main_counts
    model = UNetModel(dataclasses.replace(mcfg, num_classes=N_CLASSES), dtype=torch.bfloat16)
    model.load_state_dict(random_state_dict(torch, model, SEED + 80))
    model = model.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(SEED + 81)
    labels = torch.randint(0, N_CLASSES, (CHAINS,), generator=g, device=dev)
    x = torch.randn((CHAINS, mcfg.image_size, mcfg.image_size, 3), generator=g, device=dev)
    decode = ddim.make_decoder(lambda xx, tt: model(xx, tt, y=labels), sched, seq)
    loss_fn = engine.make_pixel_loss_fn(decode, op, y0[0])
    loss, _, grad = engine.value_and_grad(loss_fn, x)
    check(bool(torch.isfinite(loss).all() and torch.isfinite(grad).all()),
          "phase 11(d): not finite")
    label = "phase 11(d) class-conditional flagship bf16"
    rec, launches, _, _, attn_calls = counted_run(
        torch, kc, gn, counters, model, lambda: engine.value_and_grad(loss_fn, x), 1, label)
    for k, v in launches.items():
        if k != "gn_backward_calls":
            check(v * main_evals == main_launches[k], f"{label}: kernel {k} launched {v} "
                                                      f"times, the main path "
                                                      f"{main_launches[k] / main_evals} an eval")
    check(launches["attention"] == 12 == sum(attn_calls.values()),
          f"{label}: K1 {launches['attention']}, attention blocks {attn_calls}")
    rec.update(ms=1e3 * rec["s"], launches_nonzero={k: v for k, v in launches.items() if v},
               labels=labels.tolist(), card=card)
    print(f"{label}: one energy+grad evaluation (3 U-Net forwards with label_emb), {CHAINS} "
          f"chains: {rec['ms']:.1f} ms, peak memory {rec['peak_memory_gb']:.2f} GB; launches "
          f"{rec['launches_nonzero']}, the main path's an evaluation; plain versions 0; {card}")
    rec["launches"] = launches
    return rec


def phase_lpips(torch, np, card):
    """(e) LPIPS-VGG (random weights) on (8, 256, 256, 3) f32 on the card,
    timed (CUDA events), and at batch 2 against the CPU; then the pixel CLI
    (--algo ddnm, configs/ffhq.yaml) with random weight files where
    try_load_lpips looks (TORCH_HOME, and a stand-in lpips package on the
    subprocess's PYTHONPATH): its record must hold lpips."""
    dev = torch.device("cuda")
    lp = lpips_model(torch, SEED + 90)
    g = torch.Generator().manual_seed(SEED + 91)
    a, b = (torch.rand((CHAINS, 256, 256, 3), generator=g) * 2 - 1 for _ in range(2))
    ref = lp(a[:2], b[:2])
    lp, ad, bd = lp.to(dev), a.to(dev), b.to(dev)
    full = lp(ad, bd)
    ms = time_ms(lambda: lp(ad, bd), iters=5, warmup=1)
    err = float((full[:2].cpu() - ref).abs().max() / ref.abs().max())
    check(bool(torch.isfinite(full).all()) and err <= BASELINE_TOL,
          f"phase 11(e) LPIPS at 256^2: card vs CPU {err:.2e}")
    print(f"phase 11(e) LPIPS-VGG (8, 256, 256, 3) f32: {ms:.3f} ms a call (CUDA events, "
          f"host included), batch 2 card vs CPU {err:.2e} (bar {BASELINE_TOL}); {card}")
    with tempfile.TemporaryDirectory() as tmp:
        from PIL import Image
        from nshmc_tpu_torch.utils import lpips

        vgg_sd, lin_sd = lpips_weights(torch, SEED + 92)
        ckpt = os.path.join(tmp, "torch", "hub", "checkpoints")
        heads = os.path.join(tmp, "site", "lpips", "weights", "v0.1")
        os.makedirs(ckpt)
        os.makedirs(heads)
        torch.save(vgg_sd, os.path.join(ckpt, lpips.VGG16_FILE))
        torch.save(lin_sd, os.path.join(heads, "vgg.pth"))
        open(os.path.join(tmp, "site", "lpips", "__init__.py"), "w").close()
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        Image.fromarray((synthetic_image(np, 256, SEED + 93) * 255).astype(np.uint8)).save(
            os.path.join(data, "face.png"))
        env = dict(os.environ, TORCH_HOME=os.path.join(tmp, "torch"),
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(tmp, "site")]
                       + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
        cmd = [sys.executable, "-m", "nshmc_tpu_torch.cli", "--config",
               os.path.join(ROOT, "configs", "ffhq.yaml"), "--device", "cuda", "--algo", "ddnm",
               "--deg", "inpaint_random", "--data_path", data, "-i", os.path.join(tmp, "out")]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        check(r.returncode == 0 and lines and lines[-1].startswith('{"summary"')
              and "LPIPS: VGG weights loaded" in lines,
              f"CLI with LPIPS failed (rc {r.returncode}):\n{r.stdout[-3000:]}\n"
              f"{r.stderr[-3000:]}")
        with open(os.path.join(tmp, "out", "metrics.jsonl")) as f:
            rec = json.loads(f.readline())
        check(math.isfinite(rec.get("lpips", float("nan"))), f"CLI record without lpips: {rec}")
        print(f"phase 11(e) CLI --algo ddnm (configs/ffhq.yaml, cuda) with local LPIPS weights "
              f"in {time.time() - t0:.1f} s: record {rec}")
    return dict(ms=ms, batch=CHAINS, size=256, card_vs_cpu=err, cli_lpips=rec["lpips"], card=card)


def phase_ddpm_kernels(torch, gn, kc):
    """(f) K2a, K2b and K2c against their plain versions at every DDPM
    GN+SiLU site shape (kernel_check.DDPM_GN_SITES, eps 1e-6) and K2a at its
    GroupNorm32 sites, bf16 and f32, phase 3's bars (K2a two calls
    bit-identical; K2b both affine forms; K2c each design that can take the
    call and the wrapper, both forms, two calls bit-identical); the design
    `bwd_design` picks at each shape, timed in both dtypes beside the plain
    version, the F.group_norm + F.silu backward and the bound. Returns
    {K2c kernel: [records]}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 95)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    eps = kc.DDPM_EPS
    out = {"gn_backward": [], "gn_backward_twopass": []}
    picks = {}
    for shape in kc.DDPM_GN_SITES:
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
            st = kc.gn_stats_check(x, gn.NUM_GROUPS, eps, g)
            check(st["ok"], f"(f) K2a DDPM {shape} {dname}: {kc.stats_summary(st)}")
            for form in kc.AFFINE_FORMS:
                ok, err = apply_check(torch, gn, x, form, g)
                check(ok, f"(f) K2b DDPM {shape} {dname} {form}: apply max {err:.2e}")
                inputs = kc.gn_inputs(shape, dt, form, g, dev, eps)
                for design in (*gn.bwd_designs(*shape, dt.itemsize, sms), None):
                    res = kc.gn_backward_check(*inputs, design=design)
                    check(res["ok"], f"(f) K2c {design or 'wrapper'} DDPM {shape} {dname} "
                                     f"{form}: {res}")
            design = gn.bwd_design(*shape, dt.itemsize, sms)
            picks[f"{shape} {dname}"] = design
            rec = gn_backward_times(torch, gn, kc, shape, dt, design, eps, g, dev, "DDPM site")
            out[BWD_KERNELS[design]].append({**rec, "eps": eps, "sites": kc.DDPM_GN_SITES[shape]})
            del x
    for shape in kc.DDPM_NORM_SITES:
        for dt in (torch.bfloat16, torch.float32):
            x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dt)
            st = kc.gn_stats_check(x, gn.NUM_GROUPS, eps, g)
            check(st["ok"], f"(f) K2a DDPM GroupNorm32 {shape} {dt}: {kc.stats_summary(st)}")
    print(f"phase 11(f) K2a, K2b and K2c at the DDPM's {len(kc.DDPM_GN_SITES)} GN+SiLU shapes "
          f"(eps {eps:g}, bf16 and f32) and K2a at its GroupNorm32 shapes agree with their plain "
          f"versions at phase 3's bars; bwd_design picks {json.dumps(picks)}")
    return out, picks


# ---- 12. chains over processes: --mesh and multi-process runs -----------------------------------
MESH = 2  # ranks of one gloo group, both on cuda:0: the one card is shared, not split
MESH_KERNELS = ("attention", "gn_stats", "gn_apply", "gn_backward", "gn_backward_twopass")


def kernel_counters(torch):
    """name -> the object whose `.launches` counts each kernel where it
    launches (K1's two kernels, K2a, K2a's old Triton chain, K2b, K2c's two
    designs, P1-P4)."""
    from nshmc_tpu_torch.ops import attention as attn
    from nshmc_tpu_torch.ops import groupnorm as gn
    from nshmc_tpu_torch.ops import stream_probe as sp
    from nshmc_tpu_torch.scripts import groupnorm_stats_variants as stats_variants

    return {"attention": attn.KERNEL_LAUNCHES[torch.bfloat16],
            "attention_f32": attn.KERNEL_LAUNCHES[torch.float32], "gn_stats": gn.group_stats,
            "gn_stats_triton_chain": stats_variants.triton_chain,
            "gn_apply": gn.normalize_silu, "gn_backward": gn.launch_one,
            "gn_backward_twopass": gn.launch_twopass,
            **{f.__name__: f for f in sp.KERNELS}}


@contextlib.contextmanager
def device_launches(torch):
    """Yields a dict that, when the block ends, holds each kernel_counters()
    name's launches on the card while the block ran, read from a device
    trace (torch.profiler, device activity only), CUDA graph replays
    included, which no wrapper sees; and under "gn_backward_twopass_parts"
    the launches of the two-pass design's other two kernels, each."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield counts
        torch.cuda.synchronize()
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            # "void (anonymous namespace)::gn_stats_kernel<__nv_bfloat16>(uint4 const*, ...)",
            # or its mangled form "_ZN12_GLOBAL__N_115gn_stats_kernelI...", or Triton's "apply_kernel"
            name = e.name().removeprefix("void ").replace("(anonymous namespace)::", "")
            mangled = re.match(r"_Z(?:N12_GLOBAL__N_1)?(\d+)", name)
            key = ((name[mangled.end():mangled.end() + int(mangled.group(1))], True) if mangled
                   else (name.split("<")[0].split("(")[0].split("::")[-1].strip(), "(" in name))
            seen[key] = seen.get(key, 0) + 1
    counts.update({k: seen.get(v, 0) for k, v in DEVICE_KERNELS.items()})
    parts = {seen.get((n, True), 0) for n in ("gn_bwd_partial_kernel", "gn_bwd_dx_kernel")}
    counts["gn_backward_twopass_parts"] = parts.pop() if len(parts) == 1 else sorted(parts)


def release_graphs(torch, label):
    """Drop the CUDA graphs of every DDIM decoder still alive and their
    memory pools (sampling/graphs.py: a decoder keeps them while it lives,
    and no other allocation can use them), return the cached memory, and
    print what stays."""
    import gc
    from nshmc_tpu_torch.sampling import graphs

    gc.collect()
    decoders = [o for o in gc.get_objects() if isinstance(o, graphs.Decoder)]
    keys = sum(len(d.graphs) for d in decoders)
    for d in decoders:
        d.release()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"{label}: released the graphs of {keys} keys of {len(decoders)} live decoders; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved after")


def launch_ranks(argv, label, timeout=600):
    """`python3 argv...` as MESH ranks of one gloo group on localhost (the
    NSHMC_* contract, parallel/multihost.py::launch_local), from the
    checkout's root; returns their outputs. A rank that fails, or ranks
    that outlast `timeout` s together, fail the run; every rank is killed
    on the way out."""
    from nshmc_tpu_torch.parallel import multihost as mh

    try:
        return mh.launch_local(argv, MESH, timeout, cwd=ROOT)
    except RuntimeError as e:
        fail(f"{label}: {str(e)[-4000:]}")


def mesh_problem(torch, np, dev):
    """Phase 12(a)'s problem, built alike by the parent and by each rank:
    the main path's flagship (bf16, random weights from SEED, 3-step DDIM,
    92% random inpainting), y0's noise and the 8 chains' x_T drawn on the
    host as the CLI draws them, the engine's generator, one MH attempt at
    L = 20."""
    import types
    import yaml
    from nshmc_tpu_torch import schedules as sched_mod
    from nshmc_tpu_torch.cli import host_randn, image_generators
    from nshmc_tpu_torch.hmc import engine
    from nshmc_tpu_torch.models import unet
    from nshmc_tpu_torch.operators import build_operator
    from nshmc_tpu_torch.sampling import ddim

    with open(os.path.join(ROOT, "configs", "ffhq.yaml")) as f:
        cfg = yaml.safe_load(f)
    mcfg = unet.UNetConfig.from_model_yaml(**cfg["model"])
    d, c = cfg["data"]["image_size"], cfg["data"]["channels"]
    model = unet.UNetModel(mcfg, dtype=torch.bfloat16)
    model.load_state_dict(random_state_dict(torch, model, SEED))
    model = model.to(dev).eval()
    sched = sched_mod.DiffusionSchedule.create(
        cfg["diffusion"]["beta_schedule"], cfg["diffusion"]["beta_start"],
        cfg["diffusion"]["beta_end"], cfg["diffusion"]["num_diffusion_timesteps"], device=dev)
    op = build_operator("inpaint_random", c, d, np.random.default_rng(SEED), device=dev)
    host, gen = image_generators(SEED + 12, dev)
    x_orig = 2 * torch.from_numpy(synthetic_image(np, d, SEED)).to(dev)[None] - 1
    with torch.no_grad():
        y0 = op.H_img(x_orig)
    y0 = y0 + 0.1 * host_randn(y0.shape, host, dev)
    return types.SimpleNamespace(
        model=model, decode=ddim.make_decoder(model, sched, sched_mod.DDIMSequence.create(1000, 3)),
        op=op, y0=y0, x=host_randn((CHAINS, d, d, c), host, dev), gen=gen,
        hcfg=engine.HMCConfig(sigma_0=0.1, tau=1.0, epsilon=0.05, epochs=1, sampling=1,
                              max_attempts=1))


def mesh_run(torch, engine, prob, runner=None):
    """One attempt of the 8 chains, the even ones accepting every finite
    proposal (the same global draws in every process): unsharded, or through
    the sharded `runner`. Returns (the end state of all 8 chains, whether
    each of this process's chains decided clear of float noise)."""
    log = []
    draws = accepting_draws(engine, [prob.gen], prob.x, 1, EVEN)
    state = engine.init_chains(prob.hcfg, CHAINS, prob.x.shape[1:], prob.x.device, x=prob.x)
    with swapped(recording_propose(engine, log)):
        if runner is None:
            out = engine.run_hmc(engine.make_pixel_loss_fn(prob.decode, prob.op, prob.y0[0]),
                                 prob.hcfg, state, prob.gen, draws=draws)
        else:
            out = runner(prob.decode, prob.op, prob.y0[0], state, prob.gen, draws=draws)
    return out, clear_decisions(torch, log)


def mesh_rank(out_dir):
    """One rank of phase 12(a) (`chip_smoke.py --mesh-rank OUT_DIR`, under
    the NSHMC_* contract): its 4 of the 8 chains through the sharded runner
    on cuda:0, every kernel count set to 0 just before and read just after,
    one warm-up evaluation first; saves the gathered state, its decisions,
    launches (a device trace), time and peak memory to OUT_DIR/rank{i}.pt."""
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "phase 12(a) rank: no CUDA")
    sys.path.insert(0, ROOT)
    from nshmc_tpu_torch.hmc import engine
    from nshmc_tpu_torch.ops import groupnorm as gn
    from nshmc_tpu_torch.parallel import chains
    from nshmc_tpu_torch.parallel import multihost as mh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mh.maybe_initialize()
    mesh = chains.chain_mesh(MESH, "cuda:0")
    torch.cuda.set_device(mesh.device)
    prob = mesh_problem(torch, np, mesh.device)
    per = CHAINS // MESH
    engine.value_and_grad(engine.make_pixel_loss_fn(prob.decode, prob.op, prob.y0[0]),
                          prob.x[mesh.rank * per:(mesh.rank + 1) * per])  # warm-up
    runner = chains.make_sharded_hmc(prob.hcfg, mesh, engine.make_pixel_loss_fn)
    counters = kernel_counters(torch)
    for f in (*counters.values(), gn.groupnorm_silu_backward):
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_calls() as plain, device_launches(torch) as launches:
        out, clear = mesh_run(torch, engine, prob, runner)
    dt = time.perf_counter() - t0
    launches.pop("gn_backward_twopass_parts")
    rec = dict(rank=mesh.rank, device=str(mesh.device), s=dt, evals=prob.hcfg.n_leapfrog + 1,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, plain=dict(plain),
               launches=launches,
               state={k: v.cpu() for k, v in vars(out).items()}, clear=clear.cpu())
    torch.save(rec, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    mh.shutdown()
    print(f"phase 12(a) rank {mesh.rank} of {mesh.size} on {mesh.device}: done", flush=True)


def phase_mesh_library(torch, np, engine, counters, card):
    """(a) 8 flagship chains as 2 ranks x 4 through the sharded runner (both
    ranks on cuda:0) against the unsharded 8-chain run in this process, one
    attempt, the even chains accepting: decisions equal where clear of the
    bf16 noise, the moved states within DISPLACEMENT_TOL of their
    displacement (phase 9(d)'s hold: cuDNN may pick other algorithms at
    batch 4 than at 8); K1, K2a, K2b and K2c launched in each rank as often
    as in the unsharded run, no plain version. Returns the record."""
    dev = torch.device("cuda")
    prob = mesh_problem(torch, np, dev)
    evals = prob.hcfg.n_leapfrog + 1
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the decoder replays its CUDA graphs after its first calls, here and in
    # each rank: the launches are read from a device trace
    with plain_calls() as plain, device_launches(torch) as launches:
        ref, clear_ref = mesh_run(torch, engine, prob)
    dt = time.perf_counter() - t0
    unsharded = dict(s=dt, evals_per_s=evals / dt,
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    launches.pop("gn_backward_twopass_parts")
    check(not any(plain.values()) and all(launches[k] > 0 for k in MESH_KERNELS[:3])
          and launches["gn_backward"] + launches["gn_backward_twopass"] > 0,
          f"phase 12(a) unsharded run: launches {launches}, plain calls {plain}")
    x_start = prob.x.clone()
    del prob
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        launch_ranks([os.path.abspath(__file__), "--mesh-rank", tmp], "phase 12(a)")
        wall = time.time() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(MESH)]
    for r in ranks:
        lc = r["launches"]
        check(r["device"] == "cuda:0" and not any(r["plain"].values()),
              f"phase 12(a) rank {r['rank']}: device {r['device']}, plain calls {r['plain']}")
        check(all(lc[k] == launches[k] for k in MESH_KERNELS),
              f"phase 12(a) rank {r['rank']}: K1, K2a, K2b and K2c must launch as often as in "
              f"the unsharded run ({ {k: launches[k] for k in MESH_KERNELS} }): {lc}")
        for k, v in lc.items():
            if k not in MESH_KERNELS:
                check(v == 0, f"phase 12(a) rank {r['rank']}: kernel {k} launched {v} times")
        for k, v in r["state"].items():
            check(torch.equal(v, ranks[0]["state"][k]),
                  f"phase 12(a): the ranks' gathered {k} differ")
    import types
    sharded = types.SimpleNamespace(**{k: v.to(dev) for k, v in ranks[0]["state"].items()})
    clear = clear_ref & torch.cat([r["clear"] for r in ranks]).to(dev)
    worst, n_clear = compare_chains(torch, "phase 12(a)", sharded, ref, x_start, clear)
    per_rank = [dict(device=r["device"], s=r["s"], evals_per_s=r["evals"] / r["s"],
                     peak_memory_gb=r["peak_memory_gb"],
                     launches={k: v for k, v in r["launches"].items() if v}) for r in ranks]
    for r, pr in zip(ranks, per_rank):
        print(f"phase 12(a) rank {r['rank']} of {MESH} on {pr['device']}: 4 chains, one attempt "
              f"of {r['evals']} energy+grad evals in {pr['s']:.3f} s (gather included), "
              f"{pr['evals_per_s']:.3f} a second, peak memory {pr['peak_memory_gb']:.2f} GB; "
              f"launches {pr['launches']}; plain versions 0; {card}")
    rate = sum(pr["evals_per_s"] for pr in per_rank) * (CHAINS // MESH)  # chain-evaluations/s
    unsharded["launches"] = {k: v for k, v in launches.items() if v}
    print(f"phase 12(a) unsharded, 8 chains in this process: {evals} evals in "
          f"{unsharded['s']:.3f} s, {unsharded['evals_per_s']:.3f} a second "
          f"({CHAINS * unsharded['evals_per_s']:.2f} chain-evaluations/s; the ranks together "
          f"{rate:.2f}), peak memory {unsharded['peak_memory_gb']:.2f} GB; {card}")
    print(f"phase 12(a) sharded (2 ranks x 4 chains, one card) against unsharded (8 chains): "
          f"{n_clear}, equal; moved states within {worst:.3e} of their displacement "
          f"(tolerance {DISPLACEMENT_TOL}); accepted {ref.accepted.tolist()}; the ranks took "
          f"{wall:.1f} s of wall time from launch to exit")
    return {"ranks": per_rank, "unsharded": unsharded, "worst_displacement_ratio": worst,
            "compared": n_clear, "ranks_chain_evals_per_s": rate,
            "launch_to_exit_s": wall, "card": card}


def mesh_cli(np, label, argv, n_images):
    """The port's CLI as MESH ranks on cuda:0 over `n_images` synthetic
    256^2 images (the first phase 5's): returns (the ranks' outputs, the
    metrics rows, the output folder's files, seconds)."""
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        for i in range(n_images):
            Image.fromarray((synthetic_image(np, 256, SEED + 3 + i) * 255).astype(np.uint8)).save(
                os.path.join(data, "face.png" if i == 0 else f"face{i}.png"))
        out = os.path.join(tmp, "out")
        t0 = time.time()
        outs = launch_ranks(["-m", "nshmc_tpu_torch.cli", "--device", "cuda:0", *argv,
                             "--data_path", data, "-i", out], label)
        dt = time.time() - t0
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f.read().splitlines()]
        files = sorted(os.listdir(out))
    for rank, o in enumerate(outs):
        check(f"rank {rank} of {MESH}: device cuda:0" in o, f"{label}: rank {rank}'s device:\n{o}")
    summaries = [[ln for ln in o.splitlines() if ln.startswith('{"summary"')] for o in outs]
    check([len(s) for s in summaries] == [1] + [0] * (MESH - 1),
          f"{label}: summary lines by rank {summaries}")
    summary = json.loads(summaries[0][0])["summary"]
    check(math.isfinite(summary.get("psnr", float("nan"))), f"{label}: summary {summary}")
    check([r["idx"] for r in rows] == list(range(n_images))
          and all(math.isfinite(r["psnr"]) for r in rows), f"{label}: metrics rows {rows}")
    print(f"{label} in {dt:.1f} s: rows {[(r['idx'], r['file']) for r in rows]}, files {files}; "
          f"{summaries[0][0]}")
    return outs, rows, files, dt


def phase_mesh_clis(np):
    """(b) --algo hmc --mesh 2 --chains 8 on configs/ffhq.yaml, one image:
    the chains shared out, the primary alone writing the artifacts, the
    metrics row and the summary; (c) --algo ddnm over two images: rank i
    takes image i and saves it, the primary writes both rows in idx order;
    (d) --algo hmc_latent --mesh 2 --chains 8 on configs/ffhq_latent.yaml
    (f32). Returns each run's seconds."""
    ffhq = os.path.join(ROOT, "configs", "ffhq.yaml")
    one = ["0.png", "metrics.jsonl", "orig_0.png", "std_dev_map_0.png", "y0_0.png"]
    # sigma_0 0.5: the post-anneal likelihood at sigma_y 1.0, so the L = 2 proposals of
    # the random-weight prior are accepted within a few attempts
    outs, _, files, t_b = mesh_cli(np, "phase 12(b) CLI --algo hmc --mesh 2 --chains 8", [
        "--config", ffhq, "--algo", "hmc", "--deg", "inpaint_random", "--chains", str(CHAINS),
        "--mesh", str(MESH), "--tau", "0.1", "--epsilon", "0.05", "--hmc_epochs", "1",
        "--hmc_sampling", "1", "--sigma_0", "0.5"], 1)
    check(files == one, f"phase 12(b): files {files}")
    check("chains sharded over 2 processes" in outs[0], "phase 12(b): no sharded run")
    outs, _, files, t_c = mesh_cli(np, "phase 12(c) CLI --algo ddnm, 2 images", [
        "--config", ffhq, "--algo", "ddnm", "--deg", "inpaint_random", "--subset_end", "2"], 2)
    check(files == sorted(one[:3] + ["1.png", "orig_1.png", "y0_0.png", "y0_1.png"]),
          f"phase 12(c): files {files}")
    for rank, o in enumerate(outs):
        check(f"[{rank}] " in o and f"[{1 - rank}] " not in o,
              f"phase 12(c): rank {rank} did not take image {rank} alone")
    outs, _, files, t_d = mesh_cli(np, "phase 12(d) CLI --algo hmc_latent --mesh 2 --chains 8", [
        "--config", LATENT_CFG, "--algo", "hmc_latent", "--deg", "inpaint_random",
        "--chains", str(CHAINS), "--mesh", str(MESH), "--tau", "0.1", "--epsilon", "0.05",
        "--latent_epochs", "1", "--latent_sampling", "1"], 1)
    check(set(one) - {"std_dev_map_0.png"} <= set(files), f"phase 12(d): files {files}")
    return {"cli_hmc_mesh_s": t_b, "cli_ddnm_data_sharded_s": t_c, "cli_hmc_latent_mesh_s": t_d}


SD_CFG = os.path.join(ROOT, "configs", "sd21_base_latent.yaml")
SD_EVALS = 4  # (c): two eager evaluations, the capture of the decoder's graphs, a replay


def phase_sd(torch, np, engine, attn, gn, kc, counters, card):
    """13. Stable Diffusion 2.1-base (configs/sd21_base_latent.yaml at its
    published widths, bf16, seeded weights and the CLI's seeded context, 8
    chains, 92% random inpainting at 512^2). (a) The sites of one eps-net
    forward and one KL decode, by hooks: the self-attention shapes against
    kernel_check's SD_ATTN_SITES. (b) Each kernel against its plain version
    at the sites that only this path gives it: K1 at each self-attention
    shape (bf16, forward and gradient), K2a (with K2b) at the U-Net's sites
    wider than K2a's STATS_MAX_C (its channel chunks) and K2b there in both
    affine forms, and K2a, K2b and K2c at every KL decoder site (eps 1e-6;
    the 512^2 ones at (8, 262144, 256) and (8, 262144, 128)). (c) SD_EVALS
    energy+gradient evaluations under a device trace: the kernels launched
    against the sites, and the wrappers' counters against the trace (K2a's
    counts one a call, the trace one kernel a channel chunk). Returns the
    record."""
    from nshmc_tpu_torch.hmc import latent

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    t_phase = time.time()
    p = latent_problem(torch, np, SD_CFG, bf16, dev)
    state = latent.init_latent_chains(
        latent.LatentHMCConfig(sigma_0=0.1, sigma_y0=1.0, tau=1.0, epsilon=0.05, epochs=1,
                               sampling=0), CHAINS, p.z_shape, dev, z=p.z_t)
    print(f"phase 13 SD built in {time.time() - t_phase:.1f} s; context "
          f"{tuple(p.ldm.model.context.shape)}")

    # (a) the sites, by hooks
    attn_sites = {}

    def attn_hook(mod, args, out):
        key = (*args[0].shape[:2], mod.heads, mod.dim_head)
        attn_sites[key] = attn_sites.get(key, 0) + 1

    hooks = [m.register_forward_hook(attn_hook) for name, m in p.ldm.unet.named_modules()
             if name.endswith(".attn1")]
    try:
        with torch.no_grad():
            unet_gn, _, unet_norm = kc.count_sites(p.ldm.unet, lambda: p.ldm.apply_model(
                state.z, torch.full((CHAINS,), 500.0, device=dev)))
            dec_gn, _, dec_norm = kc.count_sites(p.ldm.first_stage.decoder,
                                                 lambda: p.ldm.decode_first_stage(state.z))
    finally:
        for h in hooks:
            h.remove()
    check(attn_sites == kc.SD_ATTN_SITES,
          f"phase 13 SD self-attention sites {attn_sites}, not {kc.SD_ATTN_SITES}")
    wide = sorted(s for s in unet_gn if s[2] > gn.STATS_MAX_C)
    check(bool(wide), f"phase 13 SD: no U-Net site wider than K2a's {gn.STATS_MAX_C} channels")
    print(f"phase 13 (a) SD sites: eps-net forward {dict(attn_sites)} self-attentions, "
          f"{sum(unet_gn.values())} GN+SiLU ({len(wide)} shapes above {gn.STATS_MAX_C} "
          f"channels: {wide}), {sum(unet_norm.values())} GroupNorm32; KL decode "
          f"{sum(dec_gn.values())} GN+SiLU {dict(dec_gn)}, {sum(dec_norm.values())} GroupNorm32")

    # (b) each kernel against its plain version at this path's own sites
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    attn_recs = [attention_case(torch, attn, kc, shape, bf16, g, dev)
                 for shape in sorted(attn_sites)]

    def stats_case(shape, eps, where):
        x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(bf16)
        res = kc.gn_stats_check(x, gn.NUM_GROUPS, eps, g)
        chunks = gn.stats_channel_chunks(shape[2], gn.NUM_GROUPS)
        check(res["ok"], f"phase 13 K2a {where} {shape} bf16 eps {eps} ({chunks} channel "
                         f"chunks): {kc.stats_summary(res)}")
        for form in kc.AFFINE_FORMS:
            ok, err = apply_check(torch, gn, x, form, g)
            check(ok, f"phase 13 K2b {where} {shape} bf16 {form}: apply max {err:.2e}")
        print(f"phase 13 (b) K2a, K2b {where} {shape} bf16 eps {eps}, {chunks} channel "
              f"chunk(s): {kc.stats_summary(res)}")

    for shape in wide:
        stats_case(shape, gn.EPS, "U-Net")
    for shape in sorted(set(dec_gn) | set(dec_norm)):
        stats_case(shape, 1e-6, "KL decoder")
    for shape in sorted(dec_gn):
        for form in kc.AFFINE_FORMS:
            res = kc.gn_backward_check(*kc.gn_inputs(shape, bf16, form, g, dev, eps=1e-6))
            check(res["ok"], f"phase 13 K2c KL decoder {shape} bf16 {form}: {res}")
        print(f"phase 13 (b) K2c KL decoder {shape} bf16 ({kc.wrapper_route(shape, bf16, sms)}):"
              f" dx {res['dx_err']:.2e}, affine {res['affine_rel_err']:.2e} ({res['tolerance']}),"
              f" two calls {'bit-identical' if res['same_bits'] else 'DIFFER'}")

    # (c) the kernels an evaluation launches: trace against sites and counters
    for f in (*counters.values(), gn.groupnorm_silu_backward, attn.attention_forward,
              attn.LONG_LAUNCHES):
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eval_s = []
    with plain_calls() as plain, device_launches(torch) as launches:
        for _ in range(SD_EVALS):
            t0 = time.perf_counter()
            loss, _, grad = engine.value_and_grad(p.loss_fn, state.z)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t0)
    twopass_parts = launches.pop("gn_backward_twopass_parts")
    wrappers = {k: f.launches for k, f in counters.items()}
    bwd_calls = gn.groupnorm_silu_backward.launches
    k1_calls, k1_long = attn.attention_forward.launches, attn.LONG_LAUNCHES.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def gn_count(sites, chunked):
        return sum(n * (gn.stats_channel_chunks(s[2], gn.NUM_GROUPS) if chunked else 1)
                   for s, n in sites.items())

    n_attn, n_dec_gn = sum(attn_sites.values()), sum(dec_gn.values())
    n_long = sum(n for shape, n in attn_sites.items() if attn.bf16_design(shape[1]) == "long")
    want_bwd = {"gn_backward": 0, "gn_backward_twopass": 0}
    for shape, n in dec_gn.items():
        want_bwd[BWD_KERNELS[gn.bwd_design(*shape, bf16.itemsize, sms)]] += n * SD_EVALS
    stats_calls = (3 * (gn_count(unet_gn, False) + gn_count(unet_norm, False))
                   + gn_count(dec_gn, False) + gn_count(dec_norm, False)) * SD_EVALS
    want = {"attention": 3 * n_attn * SD_EVALS,
            "gn_stats": (3 * (gn_count(unet_gn, True) + gn_count(unet_norm, True))
                         + gn_count(dec_gn, True) + gn_count(dec_norm, True)) * SD_EVALS,
            "gn_apply": (3 * sum(unet_gn.values()) + n_dec_gn) * SD_EVALS, **want_bwd}
    print(f"phase 13 (c) SD: {SD_EVALS} energy+grad evaluations (eager, eager, capture, "
          f"replay) in {[round(v, 3) for v in eval_s]} s, peak {peak_gb:.2f} GB; kernels on the "
          f"card (device trace) {launches}; the wrappers' counters {wrappers}; K2a calls "
          f"{stats_calls}; K2c calls {bwd_calls}; K1 calls {k1_calls}, {k1_long} of them in "
          f"the long-sequence design")
    check(not any(plain.values()), f"phase 13 SD: plain versions ran on the card: {plain}")
    check(bool(torch.isfinite(loss).all() and torch.isfinite(grad).all()),
          "phase 13 SD: energy or gradient not finite")
    for k, v in launches.items():
        check(v == want.get(k, 0), f"phase 13 SD: kernel {k} launched {v} times (device trace), "
                                   f"{want.get(k, 0)} expected from the sites")
    check(wrappers == {**launches, "gn_stats": stats_calls},
          f"phase 13 SD: the wrappers' counters {wrappers} are not the card's launches "
          f"{launches} (K2a: {stats_calls} calls)")
    check(twopass_parts == launches["gn_backward_twopass"] and bwd_calls == n_dec_gn * SD_EVALS,
          f"phase 13 SD: two-pass parts {twopass_parts}, K2c calls {bwd_calls}")
    check(k1_calls == launches["attention"] and k1_long == 3 * n_long * SD_EVALS,
          f"phase 13 SD: K1 calls {k1_calls} against {launches['attention']} on the card, "
          f"{k1_long} in the long-sequence design against {3 * n_long * SD_EVALS} sites "
          f"past {attn.TC_RES_MAX_T} tokens")
    del p, state, loss, grad
    release_graphs(torch, "phase 13")
    print(f"phase 13 (Stable Diffusion 2.1-base) took {time.time() - t_phase:.1f} s; {card}")
    return {"attention": attn_recs, "launches": launches, "k2a_calls": stats_calls,
            "k1_long_launches": k1_long,
            "eval_s": eval_s, "peak_memory_gb": peak_gb,
            "sites": {"attention": {str(k): v for k, v in attn_sites.items()},
                      "unet_wide": [list(s) for s in wide],
                      "kl_decoder_gn_silu": {str(k): v for k, v in dec_gn.items()}}}


def main():
    t_start = time.time()
    args = sys.argv[1:]
    trace_dir, sd_only = None, args == ["--sd"]
    if args[:1] == ["--trace"] and len(args) == 2:
        trace_dir = args[1]
    elif args[:1] == ["--mesh-rank"] and len(args) == 2:  # one rank of phase 12(a)
        return mesh_rank(args[1])
    elif args and not sd_only:
        fail("usage: chip_smoke.py [--trace OUT_DIR | --sd]")
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
        from nshmc_tpu_torch.sampling import graphs as ddim_graphs
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
    if sd_only:  # phase 13 alone
        sd = phase_sd(torch, np, engine, attn, gn, kc, kernel_counters(torch), card)
        print(json.dumps({"sd": sd}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return

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
        trace_operators(torch, np, engine, decode, x_orig, d, c, hcfg, trace_dir)
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
    counters = kernel_counters(torch)
    # one evaluation under forward hooks counts every GN+SiLU and GroupNorm32
    # call, recomputes included (a hook sends the decoder down the eager
    # ladder); the next ones warm up and capture the decoder's CUDA graphs, and
    # the MH attempts replay them (sampling/graphs.py): no wrapper runs there,
    # so the run's launches are read from a device trace
    with plain_calls() as plain:
        gn_eval, _, norm_eval = kc.count_sites(
            model, lambda: engine.value_and_grad(loss_fn, state.x))
        for _ in range(ddim_graphs.WARMUP + 1):  # eager warm-up calls, then the capture
            engine.value_and_grad(loss_fn, state.x)
    check(len(decode.graphs) == 1, f"the flagship decoder captured {len(decode.graphs)} graphs")
    (graphs_,) = decode.graphs.values()
    replays0 = graphs_.replays
    for f in (*counters.values(), gn.groupnorm_silu_backward):
        f.launches = 0
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    round_s = []

    def timed(states, rnd):
        torch.cuda.synchronize()
        round_s.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_calls() as plain_run, device_launches(torch) as launches:
        out = engine.run_hmc(loss_fn, hcfg, state, gen, callback=timed,
                             draws=accepting_draws(engine, [gen], state.x, ATTEMPTS, [0]))
    plain = {k: v + plain_run[k] for k, v in plain.items()}
    twopass_parts = launches.pop("gn_backward_twopass_parts")
    wrappers = {k: f.launches for k, f in counters.items()}  # as the replays advance them
    bwd_calls = gn.groupnorm_silu_backward.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    evals = hcfg.n_leapfrog + 1
    steps = [b - a for a, b in zip([t0] + round_s[:-1], round_s)]
    check(graphs_.replays - replays0 == evals * len(steps) and len(decode.graphs) == 1,
          f"{graphs_.replays - replays0} graph replays for {evals * len(steps)} evaluations")
    gn_calls = {k: v * evals * len(steps) for k, v in gn_eval.items()}
    norm_calls = {k: v * evals * len(steps) for k, v in norm_eval.items()}
    steady = steps[1:] or steps
    evals_per_s = evals * len(steady) / sum(steady)
    print(f"main path: {len(steps)} MH attempts x {evals} energy+grad evals, {CHAINS} chains, "
          f"bf16, each replaying the decoder's CUDA graphs, under a device trace; attempt "
          f"times {[round(s, 3) for s in steps]} s; "
          f"{evals_per_s:.3f} energy+grad evals/s (attempts 2+); peak memory {peak_gb:.2f} GB "
          f"({base_gb:.2f} allocated before the run)")
    print(f"main path kernel launches on the card (device trace): {launches} "
          f"(per energy+grad eval: "
          f"{ {k: v / (evals * len(steps)) for k, v in launches.items()} }); the two-pass "
          f"design's partial and dx kernels {twopass_parts} each")
    print(f"GN+SiLU backward calls per U-Net forward: "
          f"{(launches['gn_backward'] + launches['gn_backward_twopass']) / (3 * evals * len(steps)):.2f} "
          f"(expected one per GN+SiLU site: {n_gn}), one kernel design each: "
          f"{launches['gn_backward']} one-launch + {launches['gn_backward_twopass']} two-pass")
    check(launches["gn_backward"] + launches["gn_backward_twopass"] == 3 * evals * len(steps) * n_gn
          and twopass_parts == launches["gn_backward_twopass"],
          f"K2c launched {launches} (two-pass parts {twopass_parts}) for {n_gn} GN+SiLU sites")
    # ops/launches.py: each replay advances the wrappers' counters by what the
    # capture counted, so they must read what the card ran
    check(wrappers == launches and bwd_calls == 3 * evals * len(steps) * n_gn,
          f"the wrappers' counters {wrappers} ({bwd_calls} K2c calls) are not the card's "
          f"launches {launches}")
    n_evals = evals * len(steps)
    n_silu, n_norm = sum(gn_calls.values()), sum(norm_calls.values())
    print(f"main path K2a launches per energy+grad eval by shape (hooks; GN+SiLU, then "
          f"GroupNorm32): { {str(k): v / n_evals for k, v in sorted(gn_calls.items())} }, "
          f"{ {str(k): v / n_evals for k, v in sorted(norm_calls.items())} }; plain "
          f"version calls {plain}")
    check(launches["gn_stats"] == n_silu + n_norm and launches["gn_apply"] == n_silu,
          f"K2a launched {launches['gn_stats']} times and K2b {launches['gn_apply']} for "
          f"{n_silu} GN+SiLU and {n_norm} GroupNorm32 calls")
    check(not any(plain.values()), f"plain versions ran on the card: {plain}")
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
    eager = engine.make_pixel_loss_fn(lambda z: ddim.ddim_decode(model, sched, seq, z), op, y0[0])
    got, want = (engine.value_and_grad(f, out.x) for f in (loss_fn, eager))
    diffs = [float((a_ - b_).abs().max()) for a_, b_ in zip(got, want)]
    print(f"main path: one evaluation replayed against the eager ladder, max |diff| of loss, "
          f"decoded image, gradient {diffs}; replays {graphs_.replays}")
    check(all(torch.equal(a_, b_) for a_, b_ in zip(got, want)),
          f"the decoder's graphs disagree with the eager ladder: {diffs}")

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
            for form in kc.AFFINE_FORMS:
                ok, err = apply_check(torch, gn, x, form, g)
                check(ok, f"K2b {(b, r, cc)} {dname} {form}: apply max {err:.2e}")
                key = ("gn_apply", dname, (b, r, cc))
                worst[key] = max(worst.get(key, 0.0), err)
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
    del model32, model, out, state, decode, loss_fn, decode_w, loss_w, op_w, graphs_
    release_graphs(torch, "phases 2-4")

    # ---- 5. the port's CLI end to end ---------------------------------------------
    phase_cli(np, d, "inpaint_random")

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
    release_graphs(torch, "phase 7")

    # ---- 8. the forward operators ------------------------------------------------------------
    t0 = time.time()
    phase_operators_card_vs_cpu(torch, np, build_operator, d, c)
    model = unet.UNetModel(mcfg, dtype=torch.bfloat16)  # the main path's flagship, again
    model.load_state_dict(weights)
    model = model.to(dev).eval()
    operator_paths = phase_operator_attempts(
        torch, np, engine, gn, ddim.make_decoder(model, sched, seq), counters,
        (launches, n_evals), x_orig, d, c, hcfg)
    del model
    kernel_wizard = phase_kernel_wizard(torch, np)
    phase_cli(np, d, "sr4")
    print(f"phase 8 (the forward operators) took {time.time() - t0:.1f} s")
    release_graphs(torch, "phase 8")

    # ---- 9. the rest of the noise-space samplers and solvers ---------------------------------
    t0 = time.time()
    model = unet.UNetModel(mcfg, dtype=torch.bfloat16)  # the main path's flagship, again
    model.load_state_dict(weights)
    model = model.to(dev).eval()
    def f32_decoder():
        model32 = unet.UNetModel(mcfg)
        model32.load_state_dict(weights)
        model32 = model32.to(dev).eval()
        return model32, ddim.make_decoder(model32, sched, seq)

    p9 = Phase9(torch, np, engine, attn, gn, kc, model, ddim.make_decoder(model, sched, seq),
                counters, x_orig, d, c, sigma_0, card, f32_decoder)
    phase_noise_space(p9, hcfg)
    del model, p9.model, p9.decode
    release_graphs(torch, "phase 9 (a)-(f)")
    phase_latent_checkpoint_cli(p9)
    print(f"phase 9 (the rest of the noise-space samplers and solvers) took "
          f"{time.time() - t0:.1f} s")
    release_graphs(torch, "phase 9")

    # ---- 10. the iterative baselines ------------------------------------------------------------
    import types

    t0 = time.time()
    baseline_errs = phase_baselines_small(torch, np)
    model = unet.UNetModel(mcfg, dtype=torch.bfloat16)  # the main path's flagship, again
    model.load_state_dict(weights)
    model = model.to(dev).eval()
    flagship = types.SimpleNamespace(
        model=model, sched=sched, seq=seq, x_orig=x_orig, sigma_0=sigma_0, d=d, c=c,
        op=build_operator("inpaint_random", c, d, np.random.default_rng(SEED), device=dev))
    baselines = phase_baselines(torch, np, gn, counters, card, flagship)
    del model, flagship
    baseline_kernels = phase_baselines_kernels(torch, attn, gn, kc)
    phase_baseline_cli(np, os.path.join(ROOT, "configs", "ffhq.yaml"), "dps", d)
    phase_baseline_cli(np, LATENT_CFG, "resample", d)
    print(f"phase 10 (the iterative baselines) took {time.time() - t0:.1f} s")
    release_graphs(torch, "phase 10")

    # ---- 11. the remaining models and utilities -------------------------------------------------
    t0 = time.time()
    models_small = phase_models_small(torch, np)
    ddpm_runs = phase_ddpm(torch, np, engine, kc, gn, counters, card)
    cond_runs = phase_conditional(torch, kc, gn, counters, card)
    class_run = phase_class_conditional(torch, np, engine, gn, kc, counters, (launches, n_evals),
                                        mcfg, sched, seq, op, y0, card)
    lpips_run = phase_lpips(torch, np, card)
    ddpm_kernels, ddpm_picks = phase_ddpm_kernels(torch, gn, kc)
    print(f"phase 11 (the remaining models and utilities) took {time.time() - t0:.1f} s")
    release_graphs(torch, "phase 11")

    # ---- 12. chains over processes: --mesh and multi-process runs --------------------------------
    t0 = time.time()
    mesh = phase_mesh_library(torch, np, engine, counters, card)
    mesh["clis"] = phase_mesh_clis(np)
    print(f"phase 12 (chains over processes, {MESH} ranks on one card) took "
          f"{time.time() - t0:.1f} s")

    # ---- 13. Stable Diffusion 2.1-base's own sites and launches ----------------------------------
    sd = phase_sd(torch, np, engine, attn, gn, kc, counters, card)

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
    # each HMC run's launch counts by kernel: read from a device trace where the
    # run replays a decoder's CUDA graphs (the flagship and latent runs, phase
    # 9 (g), the mesh ranks), else counted by the wrappers where they launch
    paths = {"flagship bf16": launches, "latent bf16": latent_bf16["launches"],
             "latent f32": latent_f32["launches"],
             **{f"phase 9 {k}": r_["launches"] for k, r_ in p9.records.items()},
             **{f"phase 10 {k}": r_["launches"] for k, r_ in baselines.items()},
             **{f"phase 11 DDPM {k}": r_["launches"] for k, r_ in ddpm_runs.items()},
             **{f"phase 11 conditional {k}": r_["launches"] for k, r_ in cond_runs.items()},
             "phase 11 class-conditional bfloat16": class_run["launches"],
             "phase 13 SD bfloat16": sd["launches"]}

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
                        "path_launches": {
                            **{pth: counts[name] for pth, counts in paths.items()},
                            "mesh": {f"rank {i}": r["launches"].get(name, 0)
                                     for i, r in enumerate(mesh["ranks"])}},
                        "latent_shapes": [x for x in latent_kernels.get(key, [])
                                          if kdt in (None, x["dtype"])],
                        **({"flagship_shapes": attn_f32} if name == "attention_f32" else {}),
                        **({"batch1_shapes": baseline_kernels[name]}
                           if name in baseline_kernels else {}),
                        **({"ddpm_shapes": ddpm_kernels[name]} if name in ddpm_kernels else {}),
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

    print(f"chip_smoke.py took {time.time() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels, "main_path": {
        "energy_grad_evals_per_s": evals_per_s, "peak_memory_gb": peak_gb,
        "chains": CHAINS, "attempts": ATTEMPTS, "n_leapfrog": hcfg.n_leapfrog},
        "latent_path": {**path_record(latent_bf16), "quantizer_codes_differing": code_share},
        "latent_path_f32": path_record(latent_f32), "operator_paths": operator_paths,
        "kernel_wizard": kernel_wizard,
        "noise_space_paths": {k: {f: v for f, v in r_.items() if f != "launches"}
                              for k, r_ in p9.records.items()},
        "batch16_gradient_noise": p9.batch_noise,
        "baseline_paths": {k: {f: v for f, v in r_.items() if f != "launches"}
                           for k, r_ in baselines.items()},
        "baselines_card_vs_cpu": baseline_errs,
        "models_card_vs_cpu": models_small,
        "ddpm_paths": {k: {f: v for f, v in r_.items() if f != "launches"}
                       for k, r_ in ddpm_runs.items()},
        "conditional_unet": {k: {f: v for f, v in r_.items() if f != "launches"}
                             for k, r_ in cond_runs.items()},
        "class_conditional": {f: v for f, v in class_run.items() if f != "launches"},
        "lpips": lpips_run, "ddpm_k2c_picks": ddpm_picks, "mesh": mesh,
        "sd": {f: v for f, v in sd.items() if f != "launches"}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
