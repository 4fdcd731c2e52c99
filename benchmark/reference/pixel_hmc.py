"""The pixel noise-space HMC cell's reference (the paper's flagship): the ADM
U-Net, x_T -> 3-step DDIM -> x_0, H on x_0, and the pixel sampler's
schedule: sigma_y annealed by the accepted count (the epoch), eps backed off
after each rejection past the first, and the switch to (post_tau,
post_epsilon) once the anneal is done."""
from __future__ import annotations

import torch

from . import ddim
from .problems import Problem
from .unet import UNet, UNetSpec


def adm_spec(model: dict) -> UNetSpec:
    """guided-diffusion's create_model keys (the YAML's model block)."""
    size = model["image_size"]
    mult = model.get("channel_mult", "") or {256: (1, 1, 2, 2, 4, 4), 64: (1, 2, 3, 4)}[size]
    if isinstance(mult, str):
        mult = tuple(int(m) for m in mult.split(","))
    attn = str(model["attention_resolutions"]).split(",")
    return UNetSpec(image_size=size, in_channels=model.get("in_channels", 3),
                    model_channels=model["num_channels"],
                    out_channels=6 if model["learn_sigma"] else 3,
                    num_res_blocks=model["num_res_blocks"],
                    attention_ds=tuple(size // int(r) for r in attn),
                    channel_mult=tuple(int(m) for m in mult),
                    num_head_channels=model["num_head_channels"],
                    use_scale_shift_norm=model["use_scale_shift_norm"],
                    resblock_updown=model["resblock_updown"])


class PixelProblem(Problem):
    def __init__(self, config, traffic, op, device):
        super().__init__(config, traffic, op, device)
        self.unet = UNet(adm_spec(config["model"])).to(device)
        self.models = [self.unet]
        d = config["diffusion"]
        self.ac = ddim.alphas_cumprod(d["beta_schedule"], d["beta_start"], d["beta_end"],
                                      d["num_diffusion_timesteps"])
        self.pairs = ddim.ladder(d["num_diffusion_timesteps"], config["ddim_steps"])

    def decoded(self, x):
        x0 = ddim.decode(self.unet, self.ac, self.pairs, x)
        return x0, x0

    def flips(self, dec_a, dec_b):
        """Elements of x_0 that the final clip to [-1, 1] holds in one and
        not in the other."""
        held = lambda d: d.abs() >= 1.0
        return [int(v) for v in (held(dec_a) ^ held(dec_b)).reshape(len(dec_a), -1).sum(1)]

    def attempt_params(self, decisions):
        """Replays the schedule from the image's start: sigma_y = sigma_0 +
        anneal_scale (1 - e/E)^anneal_power at epoch e < E, else sigma_0;
        at e >= E a chain with tau above post_tau takes (post_tau,
        post_epsilon); a rejection adds to the run of rejections, which from
        2 on scales tau and eps by backoff; an accept ends the run and adds
        an epoch."""
        tr, s = self.traffic, self.traffic["sampler"]
        n = decisions.shape[1]
        sigma_0, big_e = 2.0 * tr["sigma_0"], s["epochs"]
        epoch = torch.zeros(n, dtype=torch.float64)
        tau = torch.full((n,), float(tr["tau"]), dtype=torch.float64)
        eps = torch.full((n,), float(tr["epsilon"]), dtype=torch.float64)
        run = torch.zeros(n, dtype=torch.int64)
        for a in range(decisions.shape[0] + 1):
            switch = (epoch >= big_e) & (tau > s["post_tau"])
            tau = torch.where(switch, torch.full_like(tau, s["post_tau"]), tau)
            eps = torch.where(switch, torch.full_like(eps, s["post_epsilon"]), eps)
            if a == decisions.shape[0]:
                break
            acc = decisions[a]
            run = run + 1
            back = ~acc & (run >= 2)
            tau = torch.where(back, tau * s["backoff"], tau)
            eps = torch.where(back, eps * s["backoff"], eps)
            run = torch.where(acc, torch.zeros_like(run), run)
            epoch = epoch + acc.double()
        sigma = torch.where(epoch < big_e,
                            sigma_0 + s["anneal_scale"] * (1.0 - epoch / big_e) ** s["anneal_power"],
                            torch.full_like(epoch, sigma_0))
        return eps, sigma


PROBLEM = PixelProblem
