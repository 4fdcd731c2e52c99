"""Latent-space noise-space HMC (`--algo hmc_latent`, the latent CLI): the
LDM from `cli_latent.build_latent_model` (float32, torch's TF32 defaults
left as they are), the 3-step DDIM ladder over the stop-gradient eps-net,
the VQ-f4 decode, `latent.make_latent_loss_fn` and `latent.run_latent_hmc`
(which goes through `engine.drive`), with the CLI's defaults from the
traffic file."""
from __future__ import annotations

import types

import torch

import inputs

POSITION = "z"
DECODE_PREFIXES = ("decoder.", "quantize.", "post_quant_conv.")


def first_stage_weights(shapes: dict, device, seed: int) -> dict:
    """The decode path's weights (drawn as the reference draws its own) and
    the encoder's, from two blocks."""
    dec = {k: v for k, v in shapes.items() if k.startswith(DECODE_PREFIXES)}
    rest = {k: v for k, v in shapes.items() if k not in dec}
    return {**inputs.random_state_dict(dec, device, seed, 1),
            **inputs.random_state_dict(rest, device, seed, 2)}


class Program:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from nshmc_tpu_torch.cli_latent import build_latent_model
        from nshmc_tpu_torch.hmc import latent
        from nshmc_tpu_torch.operators import build_operator
        from nshmc_tpu_torch.sampling.ddim import make_decoder
        from nshmc_tpu_torch.schedules import DDIMSequence

        self.latent, self.device = latent, device
        m = config["model"]
        self.ldm, ucfg = build_latent_model({"model": m}, types.SimpleNamespace(ckpt=""), device)
        self.ldm.unet.load_state_dict(
            inputs.random_state_dict(inputs.shapes_of(self.ldm.unet), device, seed, 0),
            strict=True)
        self.ldm.first_stage.load_state_dict(
            first_stage_weights(inputs.shapes_of(self.ldm.first_stage), device, seed),
            strict=True)
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

    @property
    def n_leapfrog(self) -> int:
        return self.cfg.n_leapfrog

    def loss_fn(self, y0: torch.Tensor, tap=None):
        """The CLI's loss; `tap(image)`, where given, sees each evaluation's
        VQ-decoded image as the loss makes it."""
        decode = self.ldm.decode_first_stage
        if tap is not None:
            def decode(z0, _decode=decode):
                img = _decode(z0)
                tap(img)
                return img
        return self.latent.make_latent_loss_fn(self.decode_z, decode, self.operator, y0)

    def init_state(self, z_t: torch.Tensor):
        return self.latent.init_latent_chains(self.cfg, z_t.shape[0], z_t.shape[1:],
                                              self.device, z=z_t)

    def run(self, loss_fn, state, draws, callback):
        return self.latent.run_latent_hmc(loss_fn, self.cfg, state, draws=draws,
                                          callback=callback)

    def value_and_grad(self, loss_fn, x):
        from nshmc_tpu_torch.hmc.engine import value_and_grad

        return value_and_grad(loss_fn, x)
