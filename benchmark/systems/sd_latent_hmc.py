"""Stable Diffusion latent noise-space HMC (`--algo hmc_latent` with
configs/sd21_base_latent.yaml): the LDM from `cli_latent.build_latent_model`
(the conditional U-Net, the KL-f8 first stage, bf16, scale_factor 0.18215),
its context set to the one drawn from the seed (reference/sd_latent_hmc.py's
Context, which the reference draws the same way), the 3-step DDIM ladder
over the stop-gradient eps-net, `latent.make_latent_loss_fn` with the
`kl.decode` span and `latent.run_latent_hmc`, with the CLI's defaults from
the traffic file. It records K1's sites and launches for the
k1_roofline_pct reader (attn_sites.py). A program without a conditional
latent model exits at once."""
from __future__ import annotations

import time
import types

import inputs
import attn_sites
from reference.sd_latent_hmc import CONTEXT_INDEX, Context
from systems import latent_hmc

POSITION = "z"
DECODE_PREFIXES = ("decoder.", "post_quant_conv.")


class Program(latent_hmc.Program):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from nshmc_tpu_torch.models.ldm import LatentDiffusion

        if not hasattr(LatentDiffusion, "set_context"):
            raise SystemExit("[bench] this program has no conditional latent model")
        from nshmc_tpu_torch.cli_latent import build_latent_model
        from nshmc_tpu_torch.hmc import latent
        from nshmc_tpu_torch.operators import build_operator
        from nshmc_tpu_torch.sampling.ddim import make_decoder
        from nshmc_tpu_torch.schedules import DDIMSequence

        self.latent, self.device = latent, device
        m = config["model"]
        self.ldm, ucfg = build_latent_model({"model": m}, types.SimpleNamespace(ckpt="", seed=seed),
                                            device)
        self.ldm.unet.load_state_dict(
            inputs.random_state_dict(inputs.shapes_of(self.ldm.unet), device, seed, 0),
            strict=True)
        shapes = inputs.shapes_of(self.ldm.first_stage)
        dec = {k: v for k, v in shapes.items() if k.startswith(DECODE_PREFIXES)}
        rest = {k: v for k, v in shapes.items() if k not in dec}
        self.ldm.first_stage.load_state_dict(
            {**inputs.random_state_dict(dec, device, seed, 1),
             **inputs.random_state_dict(rest, device, seed, CONTEXT_INDEX + 1)}, strict=True)
        ctx = Context(m["unet"]["context_dim"]).to(device)
        ctx.load_state_dict(inputs.random_state_dict(inputs.shapes_of(ctx), device, seed,
                                                     CONTEXT_INDEX), strict=True)
        self.ldm.set_context(ctx.value())
        seq = DDIMSequence.create(m["timesteps"], config["ddim_steps"])
        self.decode_z = make_decoder(self.ldm.model_fn(stop_gradient=True), self.ldm.schedule, seq)
        size, ch = config["data"]["image_size"], config["data"]["channels"]
        self.operator = build_operator(traffic["deg"], ch, size, inputs.mask_rng(seed),
                                       device=device)
        s = traffic["sampler"]
        self.cfg = latent.LatentHMCConfig(
            sigma_0=2.0 * traffic["sigma_0"], sigma_y0=s["sigma_y0"], tau=traffic["tau"],
            epsilon=traffic["epsilon"], m=traffic["m"], epochs=s["epochs"],
            sampling=s["sampling"], post_tau=s["post_tau"], post_epsilon=s["post_epsilon"],
            backoff=s["backoff"], keep_samples=min(10, max(1, s["sampling"])))
        self.x_shape = (ucfg.image_size, ucfg.image_size, ucfg.in_channels)
        self.roots = [self.ldm]

    def loss_fn(self, y0, tap=None):
        """The CLI's loss, its decode LatentDiffusion's `kl.decode` span;
        `tap(image)`, where given, sees each evaluation's decoded image."""
        decode = self.ldm.decode_first_stage
        if tap is not None:
            def decode(z0, _decode=decode):
                img = _decode(z0)
                tap(img)
                return img
        return self.latent.make_latent_loss_fn(self.decode_z, decode, self.operator, y0)

    def run(self, loss_fn, state, draws, callback):
        start, before = time.time_ns(), attn_sites.k1_launches()
        try:
            return super().run(loss_fn, state, draws, callback)
        finally:
            attn_sites.LOG.runs.append((start, time.time_ns(),
                                        attn_sites.k1_launches() - before))

    def value_and_grad(self, loss_fn, x):
        """One evaluation (the benchmark's site count), K1's sites counted."""
        evaluate = super().value_and_grad
        attn_sites.LOG.found, out = attn_sites.count(self.roots, lambda: evaluate(loss_fn, x))
        return out
