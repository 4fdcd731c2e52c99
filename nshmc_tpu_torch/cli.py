"""Experiment entry point: every algorithm of nshmc_tpu/cli.py. In the
pixel space the noise-space samplers and solvers (`--algo hmc`, `hmc_cond`,
`dmplug_adam`, `dmplug_lbfgs`) and the iterative baselines (`ddnm`, `ddrm`,
`dps`, `pigdm`, `dmps`, `reddiff`, `diffpir`, `daps`; `--noise` picks DPS's
step); through cli_latent.py, in the latent space, `--algo hmc_latent`,
`resample` and `resample_original`.

Parses the JAX CLI's flags, loads the YAML config, builds the ADM U-Net
prior and the degradation, synthesizes y0 = H(x) + sigma_0 * noise (sigma_0
doubled for the [-1, 1] range, as nshmc_tpu/cli.py:261 does), runs the
chains as one batch (or in waves, `--chain_chunk`) or the baseline from one
x_T, and writes
{idx}.png, orig_{idx}.png, y0_{idx}.png, std_dev_map_{idx}.png,
metrics.jsonl (PSNR, SSIM, and LPIPS where its weights are found locally,
utils/lpips.py::try_load_lpips) and a final {"summary": ...} line; with `--save_epochs` the
per-accept hmc_{e}.png and hmc_trail_{idx}.json, with `--diagnostics`
diagnostics_{idx}.json. `--checkpoint-dir` snapshots and resumes each
image's chains. Runs on CUDA unless `--device cpu` is given.

Several processes (parallel/multihost.py: NSHMC_DIST=1 with torchrun or the
NSHMC_* variables; one device a process): `hmc` / `hmc_latent` with
`--mesh N` > 1 shard each image's chains over the N processes
(parallel/chains.py), the primary writing the artifacts; every other run
(`--mesh` <= 1, or an algorithm that ignores `--mesh`) is data-sharded:
process i takes images i::P and writes its own. The primary puts the
metrics rows in idx order and prints the summary of every process's.

Run:  python -m nshmc_tpu_torch.cli --algo hmc --deg inpaint_random \
          --config configs/ffhq.yaml -i out/
      python -m nshmc_tpu_torch.cli --algo hmc_latent --config configs/ffhq_latent.yaml
      NSHMC_DIST=1 torchrun --nproc_per_node 2 -m nshmc_tpu_torch.cli --mesh 2 --chains 8 ...
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch
import yaml


def get_parser():
    p = argparse.ArgumentParser(description="nshmc_tpu_torch sampling CLI")
    p.add_argument("--config", default="configs/ffhq.yaml")
    p.add_argument("--algo", default="hmc",
                   help="hmc | hmc_cond | hmc_latent | dmplug_adam | dmplug_lbfgs | ddnm | "
                        "ddrm | dps | pigdm | dmps | reddiff | diffpir | daps | resample | "
                        "resample_original")
    p.add_argument("--deg", default="inpaint_random",
                   help="degradation: srN (N x N block averaging) | sr_bicubicN | "
                        "inpaint_random | inpaint_box | deblur_gauss | deblur_aniso | "
                        "deblur_nonlinear | csN (Walsh-Hadamard, 1/N kept) | color | "
                        "denoise | hdr | phase_retrieval")
    p.add_argument("--sigma_0", type=float, default=0.05)
    p.add_argument("--timesteps", type=int, default=3)
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--epsilon", type=float, default=0.05)
    p.add_argument("--m", type=float, default=1.0, help="HMC momentum mass")
    p.add_argument("--hmc_epochs", type=int, default=60, help="HMC annealing epochs")
    p.add_argument("--hmc_sampling", type=int, default=20,
                   help="HMC burn-in and kept-sample epochs")
    p.add_argument("--sigma_y", type=float, default=1.0,
                   help="latent HMC geometric anneal start")
    p.add_argument("--latent_epochs", type=int, default=50,
                   help="latent HMC anneal attempts")
    p.add_argument("--latent_sampling", type=int, default=10,
                   help="latent HMC post-anneal half-window")
    p.add_argument("--latent_full_grad", action="store_true",
                   help="differentiate through the latent eps-net in hmc_latent (the "
                        "reference stop-grads it; default off)")
    p.add_argument("--lbfgs_epochs", type=int, default=300,
                   help="DMPlug L-BFGS outer budget")
    p.add_argument("--lbfgs_inner", type=int, default=20,
                   help="DMPlug L-BFGS inner iterations per outer step")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--noise", default="ddpm", choices=["ddpm", "ddim"],
                   help="the pixel baselines' step noise: ddpm (eta-DDPM) or ddim (none); "
                        "DPS reads it")
    p.add_argument("-i", "--image_folder", default="out")
    p.add_argument("--subset_start", type=int, default=0)
    p.add_argument("--subset_end", type=int, default=1)
    p.add_argument("--chains", type=int, default=1,
                   help="HMC chains, run as the batch axis of each U-Net call")
    p.add_argument("--image_batch", type=int, default=1,
                   help="run HMC on N images at once: N x chains as one batch")
    p.add_argument("--mesh", type=int, default=0,
                   help="hmc, hmc_latent: shard the chains over N processes, one a device "
                        "(parallel/multihost.py's NSHMC_* contract or torchrun), all of "
                        "them on each image; other algorithms ignore it, and several "
                        "processes without a chain mesh split the images (i::P)")
    p.add_argument("--ckpt", default="",
                   help="reference checkpoint (random init if absent)")
    p.add_argument("--checkpoint-dir", default="",
                   help="chain-state snapshot dir: snapshot every 10 attempts and at the "
                        "end, and resume from it")
    p.add_argument("--verbose", action="store_true", help="per-attempt progress prints")
    p.add_argument("--save_epochs", action="store_true",
                   help="save hmc_{epoch}.png per accepted proposal of chain 0 and a "
                        "psnr/sigma_y trail json")
    p.add_argument("--adapt", default="none", choices=["none", "da"],
                   help="'da' = dual-averaged shared step size during annealing "
                        "(replaces the x0.95 backoff; ignored where --checkpoint-dir, "
                        "--verbose, --save_epochs or --driver observed pick the observed "
                        "driver, as in the JAX CLI)")
    p.add_argument("--diagnostics", action="store_true",
                   help="report split-R-hat/ESS over chains x kept samples")
    p.add_argument("--driver", default="auto", choices=["auto", "jit", "observed"],
                   help="accepted for the JAX CLI's command lines; it picks an XLA program "
                        "form there and nothing here, where every run is the host loop, "
                        "except that 'observed' takes precedence over --adapt da as there")
    p.add_argument("--attempts_per_round", type=int, default=1,
                   help="MH attempts between progress callbacks and snapshot checks "
                        "(statistics unchanged)")
    p.add_argument("--chain_chunk", type=int, default=0,
                   help="send the chains through the networks in sequential waves of this "
                        "size (the chain count a multiple of it; statistics unchanged)")
    p.add_argument("--unroll_ladder", default="auto",
                   help="accepted for the JAX CLI's command lines; it picks the DDIM "
                        "ladder's XLA program form there and does nothing here")
    p.add_argument("--data_path", default="", help="override the config's data.path")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    return p


LATENT_ALGOS = ("hmc_latent", "resample", "resample_original")
PIXEL_BASELINES = ("ddnm", "ddrm", "dps", "pigdm", "dmps", "reddiff", "diffpir", "daps")
PIXEL_ALGOS = ("hmc", "hmc_cond", "dmplug_adam", "dmplug_lbfgs") + PIXEL_BASELINES


SHARDED_ALGOS = ("hmc", "hmc_latent")  # --mesh > 1 shards their chains; the rest ignore it


def _check_flags(opt):
    """Raise, before any output, on an unknown algorithm, on --mesh > 1 with
    hmc / hmc_latent where the process group is not --mesh processes, on
    chains that do not split over the mesh, and on --mesh > 1 with
    --image_batch > 1 (the image batch is one run of its own)."""
    from .parallel import multihost as mh
    from .parallel.chains import LAUNCH_HINT

    if opt.algo not in PIXEL_ALGOS + LATENT_ALGOS:
        raise NotImplementedError(
            f"--algo {opt.algo} is not an algorithm of nshmc_tpu_torch; they are "
            f"{', '.join(PIXEL_ALGOS + LATENT_ALGOS)} (ROADMAP.md, Queue 1)")
    if opt.mesh > 1 and opt.algo in SHARDED_ALGOS:
        if mh.process_count() != opt.mesh:
            raise ValueError(f"--mesh {opt.mesh} shards the chains over {opt.mesh} processes, "
                             f"one a device, and this run has {mh.process_count()}: "
                             + LAUNCH_HINT.format(n=opt.mesh))
        if opt.chains % opt.mesh:
            raise ValueError(f"--chains {opt.chains} is not a multiple of --mesh {opt.mesh}")
        if opt.algo == "hmc" and opt.image_batch > 1:
            raise ValueError(f"--image_batch {opt.image_batch} does not combine with --mesh "
                             f"{opt.mesh}: shard the chains of one image at a time, or run "
                             "the image batches data-sharded (--mesh <= 1)")


def _device(name: str) -> torch.device:
    """The run's device: `name`, or with a process group this rank's card
    (parallel/multihost.py::rank_device), made the current one."""
    from .parallel import multihost as mh

    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available on this host; "
                           "pass --device cpu to run on the CPU")
    device = mh.rank_device(name)
    if mh.process_count() > 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        print(f"rank {mh.process_index()} of {mh.process_count()}: device {device}")
    return device


def work_items(opt, files):
    """This process's (idx, path) pairs and whether it writes their
    artifacts (nshmc_tpu/cli.py:263-278). One process: every image. Several,
    with --mesh > 1 and hmc / hmc_latent: every image on every process (the
    run shares its chains out), the primary writing; else (--mesh <= 1, or
    an algorithm that ignores --mesh) process i takes images i::P and
    writes its own."""
    from .parallel import multihost as mh

    items = list(enumerate(files))
    if mh.process_count() == 1:
        return items, True
    if opt.mesh > 1 and opt.algo in SHARDED_ALGOS:
        return items, mh.is_primary()
    return mh.shard_files(items), True


def print_ignored_by_mesh(opt):
    """--mesh > 1 runs the sharded driver first, as the JAX CLI's branch
    order does; say which flags it leaves out."""
    ignored = [flag for flag, on in (
        ("--checkpoint-dir", opt.checkpoint_dir), ("--verbose", opt.verbose),
        ("--save_epochs", opt.save_epochs), ("--adapt da", opt.adapt == "da"),
        ("--driver observed", opt.driver == "observed"), ("--chain_chunk", opt.chain_chunk))
        if on]
    if ignored:
        print(f"  {', '.join(ignored)} ignored: --mesh {opt.mesh} runs the sharded chains "
              f"(as the JAX CLI does)")


def load_config(path):
    with open(path) as f:
        return yaml.safe_load(f)


def host_randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    """N(0, I) of `shape` drawn on the host from the CPU `generator` and then
    moved to `device`: the same values whatever the device, as the JAX
    package's `PRNGKey(seed + idx)` draws do not depend on the backend."""
    return torch.randn(tuple(shape), generator=generator).to(device)


def image_generators(seed: int, device) -> tuple:
    """(host, engine) generators of one image, both seeded `seed` (the
    caller's seed + idx). y0's noise and the initial chain state come from
    `host`, a CPU generator; `engine` draws the per-attempt momenta and
    accept uniforms on `device` (on the CPU it is `host` itself, so that
    its draws continue the stream instead of repeating y0's noise)."""
    host = torch.Generator().manual_seed(seed)
    device = torch.device(device)
    return host, host if device.type == "cpu" else torch.Generator(device=device).manual_seed(seed)


def observe(opt, operator, path, idx, d, sigma_0, host, device, own=True):
    """Load image `idx`, synthesize y0 = H(x) + sigma_0 * noise with the
    noise from the image's host generator and, if `own`, save y0_{idx}.png
    and orig_{idx}.png. Returns (x01 (d, d, 3) numpy, y0 (1, d_y))."""
    from .utils import images as im

    x01 = im.load_image(path, d)
    x_orig = im.data_transform(torch.from_numpy(x01).to(device))[None]
    y0 = operator.H_img(x_orig)
    y0 = y0 + sigma_0 * host_randn(y0.shape, host, device)
    if own:
        im.save_image(im.inverse_data_transform(operator.H_pinv_img(y0)[0]),
                      os.path.join(opt.image_folder, f"y0_{idx}.png"))
        im.save_image(x01, os.path.join(opt.image_folder, f"orig_{idx}.png"))
    return x01, y0


def load_lpips(device):
    """The LPIPS metric on `device` where its weights are found locally, else
    None (utils/lpips.py::try_load_lpips; any other failure raises)."""
    from .utils import lpips

    fn = lpips.try_load_lpips(device)
    print("LPIPS: " + ("VGG weights loaded" if fn is not None else
                       "no local VGG / lpips weights, not reported"))
    return fn


def record(opt, idx, path, samples01, x01, dt, stats, lpips_fn=None, own=True):
    """If `own`, write {idx}.png (the last sample), std_dev_map_{idx}.png
    (several samples) and append the image's metrics.jsonl row; add PSNR
    and SSIM of every sample (S, H, W, C) in [0, 1] to `stats`, and LPIPS,
    computed on the CLI's device, where `lpips_fn` is given."""
    from .utils import images as im
    from .utils.metrics import psnr, ssim

    if own:
        im.save_image(samples01[-1], os.path.join(opt.image_folder, f"{idx}.png"))
        if samples01.shape[0] > 1:
            im.save_std_dev_map(samples01,
                                os.path.join(opt.image_folder, f"std_dev_map_{idx}.png"))
    origs = torch.from_numpy(x01)[None].expand_as(samples01)
    vals = {"psnr": psnr(samples01, origs).numpy(), "ssim": ssim(samples01, origs).numpy()}
    if lpips_fn is not None:
        dev = torch.device(opt.device)
        vals["lpips"] = lpips_fn(2 * samples01.to(dev) - 1, 2 * origs.to(dev) - 1).cpu().numpy()
    stats.update(vals)
    rec = {"idx": idx, "file": os.path.basename(path), "algo": opt.algo,
           "deg": opt.deg, "wall_s": round(dt, 2),
           **{k: float(np.mean(v)) for k, v in vals.items()}}
    if own:
        with open(os.path.join(opt.image_folder, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(f"[{idx}] {os.path.basename(path)}: "
          + ", ".join(f"{k}={np.mean(v):.4f}" for k, v in vals.items())
          + f"  ({dt:.1f}s)")


def finish(opt, stats, n_rows):
    """Print (the primary) and return the run's summary: the running stats
    of every process that wrote `n_rows` > 0 metrics rows, merged (one
    process: its own). With several processes the primary then puts the
    run's rows, the last of metrics.jsonl, in idx order
    (nshmc_tpu/cli.py:505-533)."""
    from .parallel import multihost as mh
    from .utils.metrics import RunningStats

    parts = mh.gather_records([(stats, n_rows)] if n_rows else [])
    summary = RunningStats.merged([p for p, _ in parts]).summary()
    if not mh.is_primary():
        return summary
    n = sum(k for _, k in parts)
    if mh.process_count() > 1 and n:
        path = os.path.join(opt.image_folder, "metrics.jsonl")
        with open(path) as f:
            lines = f.read().splitlines()
        head, run = lines[:len(lines) - n], lines[len(lines) - n:]
        run.sort(key=lambda ln: json.loads(ln)["idx"])
        with open(path, "w") as f:
            f.writelines(ln + "\n" for ln in head + run)
    print(json.dumps({"summary": summary}))
    return summary


def build_pixel_model(cfg, opt, device):
    from .models.unet import UNetConfig, UNetModel

    mcfg = UNetConfig.from_model_yaml(**cfg["model"])
    ckpt = opt.ckpt or cfg["model"].get("model_path", "")
    torch.manual_seed(0)  # the random init (no checkpoint) is reproducible
    model = UNetModel(mcfg, dtype=torch.bfloat16 if opt.bf16 else torch.float32)
    if ckpt and os.path.exists(ckpt):
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        print(f"loaded checkpoint {ckpt}")
    else:
        # the reference's behaviour on a missing checkpoint: random init
        print(f"checkpoint {ckpt!r} not found: random init")
    return model.to(device).eval(), mcfg


def run_pixel(opt):
    from .hmc.engine import HMCConfig
    from .operators import build_operator
    from .sampling.ddim import make_decoder
    from .schedules import DDIMSequence, DiffusionSchedule
    from .utils import images as im
    from .utils.metrics import RunningStats

    _check_flags(opt)
    device = _device(opt.device)
    cfg = load_config(opt.config)
    d = cfg["data"]["image_size"]
    c = cfg["data"]["channels"]
    rng = np.random.default_rng(opt.seed)

    model, _ = build_pixel_model(cfg, opt, device)
    sched = DiffusionSchedule.create(
        cfg["diffusion"]["beta_schedule"], cfg["diffusion"]["beta_start"],
        cfg["diffusion"]["beta_end"], cfg["diffusion"]["num_diffusion_timesteps"],
        device=device)
    seq = DDIMSequence.create(opt.num_timesteps, opt.timesteps)
    decode = make_decoder(model, sched, seq)
    operator = build_operator(opt.deg, c, d, rng, device=device)
    sigma_0 = 2.0 * opt.sigma_0  # [-1, 1] range scaling
    hmc_cfg = HMCConfig(sigma_0=sigma_0, tau=opt.tau, epsilon=opt.epsilon, m=opt.m,
                        epochs=opt.hmc_epochs, sampling=opt.hmc_sampling)

    files = im.list_dataset(opt.data_path or cfg["data"]["path"])
    items, own = work_items(opt, files[opt.subset_start:opt.subset_end])
    os.makedirs(opt.image_folder, exist_ok=True)
    stats = RunningStats()
    lpips_fn = load_lpips(device)
    if opt.algo == "hmc" and opt.image_batch > 1:
        return _run_pixel_hmc_batched(opt, decode, operator, hmc_cfg, items, own, d, c,
                                      sigma_0, device, stats, lpips_fn)
    run = {"hmc": functools.partial(_pixel_hmc, own=own),
           "hmc_cond": _pixel_hmc_cond}.get(opt.algo, _pixel_dmplug)
    if opt.algo in PIXEL_BASELINES:
        run = functools.partial(_pixel_baseline, model=model, sched=sched, seq=seq)
    for idx, path in items:
        host, gen = image_generators(opt.seed + idx, device)
        x01, y0 = observe(opt, operator, path, idx, d, sigma_0, host, device, own)
        t0 = time.time()
        x_t = host_randn((opt.chains if opt.algo.startswith("hmc") else 1, d, d, c), host,
                         device)
        samples = run(opt, idx, x01, y0, x_t, decode, operator, hmc_cfg, gen)
        samples01 = im.inverse_data_transform(samples.reshape(-1, d, d, c)).cpu()
        record(opt, idx, path, samples01, x01, time.time() - t0, stats, lpips_fn, own)
    return finish(opt, stats, len(items) if own else 0)


def _pixel_hmc(opt, idx, x01, y0, x_t, decode, operator, hmc_cfg, gen, own=True):
    """--algo hmc on one image (nshmc_tpu/cli.py:317-436): with --mesh > 1
    the chains sharded over the processes; else the observed driver's
    progress, trail and snapshots where a flag asks for them, else dual
    averaging with --adapt da, else the plain run; then the diagnostics
    (written if `own`). Returns the kept samples."""
    from .hmc.engine import init_chains, make_pixel_loss_fn, run_hmc
    from .utils import images as im
    from .utils.metrics import psnr

    loss_fn = make_pixel_loss_fn(decode, operator, y0[0])
    states = init_chains(hmc_cfg, x_t.shape[0], x_t.shape[1:], x_t.device, x=x_t)
    waves = dict(attempts_per_round=opt.attempts_per_round, chain_chunk=opt.chain_chunk)
    if opt.mesh > 1:
        from .parallel import multihost as mh
        from .parallel.chains import acceptance_stats, chain_mesh, make_sharded_hmc

        print_ignored_by_mesh(opt)
        runner = make_sharded_hmc(hmc_cfg, chain_mesh(opt.mesh, x_t.device), make_pixel_loss_fn)
        out = runner(decode, operator, y0[0], states, gen)
        if mh.is_primary():
            print(f"  chains sharded over {opt.mesh} processes: "
                  f"{json.dumps(acceptance_stats(out, hmc_cfg))}")
    elif opt.checkpoint_dir or opt.verbose or opt.save_epochs or opt.driver == "observed":
        if opt.adapt == "da":
            print("  --adapt da ignored: --checkpoint-dir, --verbose, --save_epochs or "
                  "--driver observed runs the observed driver (as the JAX CLI does)")
        orig01 = torch.from_numpy(x01)[None]
        # chain 0's trail: one entry and one hmc_{e-1}.png per new accepted epoch
        trail = {"epoch": [], "psnr": [], "sigma_y": [], "tau": []}

        def report(states, rnd):
            e = int(states.epoch[0])
            dec01 = im.inverse_data_transform(states.last_decoded[:1]).cpu()
            p = float(psnr(dec01, orig01)[0])
            if opt.verbose:
                print(f"  attempt {rnd}: epoch {e} PSNR {p:.2f} "
                      f"sigma_y {float(states.sigma_y[0]):.3f} "
                      f"tau {float(states.tau[0]):.3f}")
            if e > 0 and e > (trail["epoch"] or [-1])[-1]:
                for k, v in (("epoch", e), ("psnr", p), ("sigma_y", float(states.sigma_y[0])),
                             ("tau", float(states.tau[0]))):
                    trail[k].append(v)
                if opt.save_epochs:
                    im.save_image(dec01[0], os.path.join(opt.image_folder, f"hmc_{e - 1}.png"))

        out = run_hmc(loss_fn, hmc_cfg, states, gen,
                      callback=report if (opt.verbose or opt.save_epochs) else None,
                      checkpoint_dir=(os.path.join(opt.checkpoint_dir, f"img{idx}")
                                      if opt.checkpoint_dir else ""), **waves)
        if trail["epoch"]:
            with open(os.path.join(opt.image_folder, f"hmc_trail_{idx}.json"), "w") as f:
                json.dump(trail, f)
    elif opt.adapt == "da":
        from .hmc.adaptation import run_hmc_dual_averaging

        out, da = run_hmc_dual_averaging(loss_fn, hmc_cfg, states, generator=gen)
        print(f"  dual-averaged eps: {float(torch.exp(da.log_eps_avg)):.4f} "
              f"({int(da.t)} rounds)")
    else:
        out = run_hmc(loss_fn, hmc_cfg, states, gen, **waves)
    if opt.diagnostics and opt.chains > 1 and out.samples.shape[1] >= 4:
        from .utils.diagnostics import format_summary, summarize_chains

        diag = summarize_chains(out.samples)
        print(f"  diagnostics: {format_summary(diag)}")
        if own:
            with open(os.path.join(opt.image_folder, f"diagnostics_{idx}.json"), "w") as f:
                json.dump(diag, f)
    return out.samples


def _pixel_hmc_cond(opt, idx, x01, y0, x_t, decode, operator, hmc_cfg, gen):
    """--algo hmc_cond: mass-conditioned HMC (nshmc_tpu/cli.py:299-314)."""
    from .hmc.adaptation import (ConditionedHMCConfig, init_conditioned_chains,
                                 run_conditioned_hmc)
    from .hmc.engine import make_pixel_loss_fn

    ccfg = ConditionedHMCConfig(sigma_0=hmc_cfg.sigma_0, tau=opt.tau, epsilon=opt.epsilon,
                                epochs=opt.hmc_epochs, sampling=opt.hmc_sampling)
    states = init_conditioned_chains(ccfg, x_t.shape[0], x_t.shape[1:], x_t.device, x=x_t)
    out = run_conditioned_hmc(make_pixel_loss_fn(decode, operator, y0[0]), ccfg, states, gen,
                              chain_chunk=opt.chain_chunk)
    return out.samples


def _pixel_baseline(opt, idx, x01, y0, x_t, decode, operator, hmc_cfg, gen, *, model, sched,
                    seq):
    """An iterative baseline from x_T (nshmc_tpu/cli.py:463-477): each step's
    draws from the image's device generator. Returns the final x0."""
    from .algos import build_algo, run_daps
    from .sampling.loop import iterative_sampling

    sigma_0 = hmc_cfg.sigma_0
    if opt.algo == "daps":
        return run_daps(model, sched, seq, build_algo("daps", operator, sigma_0, opt.deg), x_t,
                        y0, gen)
    algo = build_algo(opt.algo, operator, sigma_0, opt.deg, noise=opt.noise)
    return iterative_sampling(model, sched, seq, algo, x_t, y0, gen)


def _pixel_dmplug(opt, idx, x01, y0, x_t, decode, operator, hmc_cfg, gen):
    """--algo dmplug_adam / dmplug_lbfgs from x_t (nshmc_tpu/cli.py:442-462).
    Returns the decoded image."""
    from .solvers import dmplug

    def loss_and_decode(x):
        x0 = decode(x)
        return torch.sum((y0 - operator.H_img(x0)) ** 2), x0

    if opt.algo == "dmplug_adam":
        return dmplug.dmplug_adam(loss_and_decode, x_t)[1]
    return dmplug.dmplug_lbfgs(loss_and_decode, x_t, epochs=opt.lbfgs_epochs,
                               max_inner=opt.lbfgs_inner)[1]


def _run_pixel_hmc_batched(opt, decode, operator, hmc_cfg, items, own, d, c, sigma_0, device,
                           stats, lpips_fn):
    """--image_batch N: N images x chains as one batch (run_hmc_multi,
    nshmc_tpu/cli.py:540-616), over this process's (idx, path) `items`,
    their artifacts written if `own`. Each image draws y0's noise, its
    initial state and its momenta from its own generators, as it would
    alone."""
    from .hmc.engine import init_chains, make_pixel_loss_fn, run_hmc_multi
    from .utils import images as im

    for start in range(0, len(items), opt.image_batch):
        batch = items[start:start + opt.image_batch]
        xs, y0s, gens, origs = [], [], [], []
        for idx, path in batch:
            host, gen = image_generators(opt.seed + idx, device)
            x01, y0 = observe(opt, operator, path, idx, d, sigma_0, host, device, own)
            xs.append(host_randn((opt.chains, d, d, c), host, device))
            y0s.append(y0)
            gens.append(gen)
            origs.append(x01)
        states = init_chains(hmc_cfg, len(batch) * opt.chains, (d, d, c), device,
                             x=torch.cat(xs))
        t0 = time.time()
        out = run_hmc_multi(lambda y: make_pixel_loss_fn(decode, operator, y), hmc_cfg,
                            states, torch.cat(y0s), gens)
        dt = (time.time() - t0) / len(batch)
        for bi, (idx, path) in enumerate(batch):
            samples = out.samples[bi * opt.chains:(bi + 1) * opt.chains]
            record(opt, idx, path, im.inverse_data_transform(samples.reshape(-1, d, d, c)).cpu(),
                   origs[bi], dt, stats, lpips_fn, own)
    return finish(opt, stats, len(items) if own else 0)


def main(argv=None):
    from .parallel import multihost

    opt = get_parser().parse_args(argv)
    multihost.maybe_initialize()  # env-gated (NSHMC_DIST=1) process group
    if opt.algo in LATENT_ALGOS:
        from .cli_latent import run_latent

        summary = run_latent(opt)
    else:
        summary = run_pixel(opt)
    multihost.shutdown()
    return summary


if __name__ == "__main__":
    main()
