"""Pixel-space noise-space HMC (the pixel CLI's `--algo hmc`): the ADM U-Net
from `cli.build_pixel_model`, the 3-step DDIM decoder, the operator from
`operators.build_operator`, `engine.make_pixel_loss_fn` and `engine.run_hmc`
(which goes through `engine.drive`), with the CLI's defaults from the
traffic file."""
from __future__ import annotations

import types

import torch

import inputs

POSITION = "x"


class Program:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from nshmc_tpu_torch.cli import build_pixel_model
        from nshmc_tpu_torch.hmc import engine
        from nshmc_tpu_torch.operators import build_operator
        from nshmc_tpu_torch.sampling.ddim import make_decoder
        from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule

        self.engine, self.device = engine, device
        opt = types.SimpleNamespace(ckpt="", bf16=config["dtype"] == "bfloat16")
        self.model, _ = build_pixel_model({"model": config["model"]}, opt, device)
        self.model.load_state_dict(
            inputs.random_state_dict(inputs.shapes_of(self.model), device, seed), strict=True)
        d = config["diffusion"]
        sched = DiffusionSchedule.create(d["beta_schedule"], d["beta_start"], d["beta_end"],
                                         d["num_diffusion_timesteps"], device=device)
        seq = DDIMSequence.create(d["num_diffusion_timesteps"], config["ddim_steps"])
        self.decode = make_decoder(self.model, sched, seq)
        size, ch = config["data"]["image_size"], config["data"]["channels"]
        self.operator = build_operator(traffic["deg"], ch, size, inputs.mask_rng(seed),
                                       device=device)
        s = traffic["sampler"]
        self.cfg = engine.HMCConfig(sigma_0=2.0 * traffic["sigma_0"], tau=traffic["tau"],
                                    epsilon=traffic["epsilon"], m=traffic["m"],
                                    epochs=s["epochs"], sampling=s["sampling"],
                                    anneal_scale=s["anneal_scale"],
                                    anneal_power=s["anneal_power"], post_tau=s["post_tau"],
                                    post_epsilon=s["post_epsilon"], backoff=s["backoff"])
        self.x_shape = (size, size, ch)
        self.roots = [self.model]

    @property
    def n_leapfrog(self) -> int:
        return self.cfg.n_leapfrog

    def loss_fn(self, y0: torch.Tensor, tap=None):
        """The CLI's loss; its decoded output is the image H reads, so there
        is nothing apart for `tap` to see."""
        return self.engine.make_pixel_loss_fn(self.decode, self.operator, y0)

    def init_state(self, x_t: torch.Tensor):
        return self.engine.init_chains(self.cfg, x_t.shape[0], x_t.shape[1:], self.device, x=x_t)

    def run(self, loss_fn, state, draws, callback):
        return self.engine.run_hmc(loss_fn, self.cfg, state, draws=draws, callback=callback)

    def value_and_grad(self, loss_fn, x):
        return self.engine.value_and_grad(loss_fn, x)
