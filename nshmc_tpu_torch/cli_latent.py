"""Latent-space experiment entry point, `--algo hmc_latent`, `resample` and
`resample_original` (port of nshmc_tpu/cli_latent.py; `python -m
nshmc_tpu_torch.cli` dispatches here).

Builds the LDM (latent U-Net + VQ-f4 first stage, f32, random weights from
seed 0 unless the config's checkpoint exists) and samples z_T at the latent
shape. `hmc_latent` runs latent noise-space HMC with the chains as one batch
(or in waves, `--chain_chunk`; snapshots and resume under
`--checkpoint-dir`; sharded over the processes with `--mesh` > 1) and
decodes the kept z0 latents (or, where no chain kept one, the final chain
states through the DDIM ladder); `resample` runs
ReSample over the DDIM ladder with the eps-net differentiated, and
`resample_original` the original sampler (max(--timesteps, 10) DDIM steps,
eps-net stop-grad), each from one z_T, its final latent decoded. Each writes
the pixel CLI's artifacts, metrics.jsonl and {"summary": ...} line.

Run:  python -m nshmc_tpu_torch.cli --algo hmc_latent --config configs/ffhq_latent.yaml
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch


def extract_kept_samples(rings: np.ndarray, kept: np.ndarray) -> np.ndarray:
    """Flatten the per-chain sample rings to their valid (most recent)
    entries. rings: (chains, keep_samples, ...), newest last, zero-padded at
    the front; kept: (chains,) kept-sample counts. Returns a stacked
    (sum(min(kept, keep)), ...) array, empty if no chain kept anything."""
    keep = rings.shape[1]
    parts = [rings[i, keep - min(int(k), keep):]
             for i, k in enumerate(np.asarray(kept)) if int(k) > 0]
    if not parts:
        return np.zeros((0,) + rings.shape[2:], rings.dtype)
    return np.concatenate(parts)


def latent_configs(cfg):
    """A latent YAML config's (latent U-Net config, AutoencoderConfig)."""
    from .models.ldm import AutoencoderConfig, latent_unet_config

    u, fs = cfg["model"]["unet"], cfg["model"]["first_stage"]
    unet_cfg = latent_unet_config(
        image_size=cfg["model"]["image_size"], model_channels=u["model_channels"],
        num_res_blocks=u["num_res_blocks"], channel_mult=tuple(u["channel_mult"]),
        attention_ds=tuple(u["attention_resolutions"]),
        num_head_channels=u["num_head_channels"])
    ae_cfg = AutoencoderConfig(
        ch=fs["ch"], ch_mult=tuple(fs["ch_mult"]), num_res_blocks=fs["num_res_blocks"],
        z_channels=fs["z_channels"], embed_dim=fs["embed_dim"], n_embed=fs["n_embed"],
        resolution=fs["resolution"])
    return unet_cfg, ae_cfg


def build_latent_model(cfg, opt, device):
    """The config's LDM, f32, on `device`: (LatentDiffusion, latent U-Net
    config)."""
    from .models.ldm import LatentDiffusion

    unet_cfg, ae_cfg = latent_configs(cfg)
    ldm = LatentDiffusion.create(unet_cfg, ae_cfg, linear_start=cfg["model"]["linear_start"],
                                 linear_end=cfg["model"]["linear_end"],
                                 num_timesteps=cfg["model"]["timesteps"], device=device)
    ckpt = opt.ckpt or cfg["model"].get("ckpt_path", "")
    if ckpt and os.path.exists(ckpt):
        sd = torch.load(ckpt, map_location="cpu", weights_only=False)  # a Lightning checkpoint
        ldm.load_checkpoint(sd.get("state_dict", sd))
        print(f"loaded LDM checkpoint {ckpt}")
    else:
        print(f"LDM checkpoint {ckpt!r} not found: random init")
    return ldm, unet_cfg


def run_latent(opt):
    from .cli import (_check_flags, _device, finish, host_randn, image_generators, load_config,
                      load_lpips, observe, print_ignored_by_mesh, record, work_items)
    from .hmc.latent import (LatentHMCConfig, init_latent_chains, make_latent_loss_fn,
                             run_latent_hmc)
    from .operators import build_operator
    from .sampling.ddim import make_decoder
    from .schedules import DDIMSequence
    from .utils import images as im
    from .utils.metrics import RunningStats

    _check_flags(opt)
    device = _device(opt.device)
    cfg = load_config(opt.config)
    d, c = cfg["data"]["image_size"], cfg["data"]["channels"]
    rng = np.random.default_rng(opt.seed)
    ldm, unet_cfg = build_latent_model(cfg, opt, device)
    z_shape = (unet_cfg.image_size, unet_cfg.image_size, unet_cfg.in_channels)
    seq = DDIMSequence.create(cfg["model"]["timesteps"], opt.timesteps)
    decode_z = make_decoder(ldm.model_fn(stop_gradient=not opt.latent_full_grad),
                            ldm.schedule, seq)
    operator = build_operator(opt.deg, c, d, rng, device=device)
    sigma_0 = 2.0 * opt.sigma_0  # [-1, 1] range scaling
    hmc_cfg = LatentHMCConfig(sigma_0=sigma_0, sigma_y0=opt.sigma_y, tau=opt.tau,
                              epsilon=opt.epsilon, m=opt.m, epochs=opt.latent_epochs,
                              sampling=opt.latent_sampling,
                              keep_samples=min(10, max(1, opt.latent_sampling)))

    files = im.list_dataset(opt.data_path or cfg["data"]["path"])
    items, own = work_items(opt, files[opt.subset_start:opt.subset_end])
    os.makedirs(opt.image_folder, exist_ok=True)
    stats = RunningStats()
    lpips_fn = load_lpips(device)
    for idx, path in items:
        host, gen = image_generators(opt.seed + idx, device)
        x01, y0 = observe(opt, operator, path, idx, d, sigma_0, host, device, own)
        t0 = time.time()
        if opt.algo != "hmc_latent":
            z = host_randn((1, *z_shape), host, device)
            samples = _latent_resample(opt, ldm, seq, operator, sigma_0, y0, z, gen)
            record(opt, idx, path, im.inverse_data_transform(samples).cpu(), x01,
                   time.time() - t0, stats, lpips_fn, own)
            continue

        def report(states, rnd):
            # the Hamiltonian's parts and the acceptance ratio of chain 0
            sig = float(states.sigma_y[0])
            ratio = float(torch.exp(torch.clamp(states.last_log_ratio[0], max=0.0)))
            print(f"  attempt {rnd}: accepted {int(states.accepted[0])} "
                  f"H: prior {0.5 * float(torch.sum(states.z[0] ** 2)):.1f} "
                  f"+ lik {float(states.last_loss[0]) / (2.0 * sig**2):.1f} "
                  f"accept_ratio {ratio:.3f} sigma_y {sig:.3f} "
                  f"tau {float(states.tau[0]):.3f}")

        states = init_latent_chains(hmc_cfg, opt.chains, z_shape, device,
                                    z=host_randn((opt.chains, *z_shape), host, device))
        if opt.mesh > 1:  # the chains sharded over the processes
            from .parallel.chains import chain_mesh, make_sharded_latent_hmc

            print_ignored_by_mesh(opt)
            runner = make_sharded_latent_hmc(
                hmc_cfg, chain_mesh(opt.mesh, device),
                lambda dec_z, op, y: make_latent_loss_fn(dec_z, ldm.decode_first_stage, op, y))
            out = runner(decode_z, operator, y0[0], states, gen)
        else:
            # --save_epochs is accepted and unused, as in the JAX latent CLI
            out = run_latent_hmc(make_latent_loss_fn(decode_z, ldm.decode_first_stage,
                                                     operator, y0[0]),
                                 hmc_cfg, states, gen, callback=report if opt.verbose else None,
                                 checkpoint_dir=(os.path.join(opt.checkpoint_dir, f"img{idx}")
                                                 if opt.checkpoint_dir else ""),
                                 attempts_per_round=opt.attempts_per_round,
                                 chain_chunk=opt.chain_chunk)
        z_samples = extract_kept_samples(out.samples.cpu().numpy(), out.n_kept.cpu().numpy())
        with torch.no_grad():
            if z_samples.shape[0] == 0:
                # no post-anneal accept: decode the final chain states
                z0 = decode_z(out.z)
            else:
                z0 = torch.from_numpy(z_samples).to(device)
            samples = torch.cat([ldm.decode_first_stage(z)
                                 for z in z0.split(max(1, opt.chains))])
        samples01 = im.inverse_data_transform(samples).cpu()
        record(opt, idx, path, samples01, x01, time.time() - t0, stats, lpips_fn, own)
    return finish(opt, stats, len(items) if own else 0)


def _latent_resample(opt, ldm, seq, operator, sigma_0, y0, z, gen):
    """--algo resample / resample_original from z_T (nshmc_tpu/cli_latent.py:
    281-309); the step draws from the device generator. Returns the decoded
    final latent."""
    if opt.algo == "resample":
        from .algos.resample import ReSample
        from .sampling.loop import iterative_sampling

        algo = ReSample(operator=operator, sigma_0=sigma_0, decode_fn=ldm.decode_first_stage)
        z_out = iterative_sampling(ldm.model_fn(stop_gradient=False), ldm.schedule, seq, algo,
                                   z, y0, gen)
    else:
        from .sampling.resample_original import (ResampleOriginalConfig,
                                                 resample_original_sample)

        z_out = resample_original_sample(
            ldm.model_fn(stop_gradient=True), ldm.schedule, ldm.decode_first_stage,
            ldm.encode_first_stage, operator, y0, z,
            ResampleOriginalConfig(ddim_steps=max(opt.timesteps, 10)), gen)
    with torch.no_grad():
        return ldm.decode_first_stage(z_out)
