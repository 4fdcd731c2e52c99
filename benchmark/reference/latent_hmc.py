"""The latent noise-space HMC cell's reference: the LDM's eps-net held
constant (no gradient through it) in the 3-step DDIM ladder, z_T -> z_0 ->
VQ-f4 decode -> image -> H; and the latent sampler's schedule: sigma_y on a
geometric anneal by attempt, moved only on an accept, and (tau, eps) backed
off after every two rejections in a row, pinned to (post_tau, post_epsilon)
by an accept after the anneal."""
from __future__ import annotations

import torch

from . import ddim
from .problems import Problem
from .unet import UNet, UNetSpec
from .vq import VQDecode, VQSpec


def ldm_unet_spec(unet: dict) -> UNetSpec:
    """openaimodel.UNetModel's keys; attention_resolutions are downsampling
    factors."""
    return UNetSpec(image_size=unet["image_size"], in_channels=unet["in_channels"],
                    model_channels=unet["model_channels"], out_channels=unet["out_channels"],
                    num_res_blocks=unet["num_res_blocks"],
                    attention_ds=tuple(unet["attention_resolutions"]),
                    channel_mult=tuple(unet["channel_mult"]),
                    num_head_channels=unet["num_head_channels"],
                    use_scale_shift_norm=False, resblock_updown=False)


def vq_spec(fs: dict) -> VQSpec:
    return VQSpec(ch=fs["ch"], ch_mult=tuple(fs["ch_mult"]), num_res_blocks=fs["num_res_blocks"],
                  z_channels=fs["z_channels"], embed_dim=fs["embed_dim"], n_embed=fs["n_embed"])


class LatentProblem(Problem):
    def __init__(self, config, traffic, op, device):
        super().__init__(config, traffic, op, device)
        m = config["model"]
        self.unet = UNet(ldm_unet_spec(m["unet"])).to(device)
        self.vq = VQDecode(vq_spec(m["first_stage"])).to(device)
        self.models = [self.unet, self.vq]
        self.ac = ddim.alphas_cumprod("quad", m["linear_start"], m["linear_end"], m["timesteps"])
        self.pairs = ddim.ladder(m["timesteps"], config["ddim_steps"])

    def decoded(self, z):
        z0 = ddim.decode(self.unet, self.ac, self.pairs, z, eps_grad=False)
        return z0, self.vq(z0)

    def flips(self, dec_a, dec_b):
        """Latent positions whose nearest VQ code differs between two z_0."""
        cb = self.vq.quantize.embedding.weight.float()

        def codes(z):
            flat = z.reshape(-1, cb.shape[1]).float()
            d = (flat ** 2).sum(1, keepdim=True) - 2 * flat @ cb.T + (cb ** 2).sum(1)[None]
            return torch.argmin(d, dim=1).reshape(len(z), -1)
        return [int(v) for v in (codes(dec_a) != codes(dec_b)).sum(1)]

    def attempt_params(self, decisions):
        """Replays the schedule from the image's start (attempt a = 0): an
        accept at attempt a sets sigma_y = sigma_y0 (sigma_0 / sigma_y0)^(a/E)
        while a < E, else sigma_0 and pins (tau, eps) to (post_tau,
        post_epsilon); a second rejection in a row scales tau and eps by
        backoff and starts the count again."""
        tr, s = self.traffic, self.traffic["sampler"]
        n = decisions.shape[1]
        sigma_0, sigma_y0, big_e = 2.0 * tr["sigma_0"], float(s["sigma_y0"]), s["epochs"]
        sigma = torch.full((n,), sigma_y0, dtype=torch.float64)
        tau = torch.full((n,), float(tr["tau"]), dtype=torch.float64)
        eps = torch.full((n,), float(tr["epsilon"]), dtype=torch.float64)
        run = torch.zeros(n, dtype=torch.int64)
        for a in range(decisions.shape[0]):
            acc, in_anneal = decisions[a], a < big_e
            new_sigma = sigma_y0 * (sigma_0 / sigma_y0) ** (a / big_e) if in_anneal else sigma_0
            sigma = torch.where(acc, torch.full_like(sigma, new_sigma), sigma)
            pin = acc & (not in_anneal)
            tau = torch.where(pin, torch.full_like(tau, s["post_tau"]), tau)
            eps = torch.where(pin, torch.full_like(eps, s["post_epsilon"]), eps)
            run = run + 1
            back = ~acc & (run >= 2)
            tau = torch.where(back, tau * s["backoff"], tau)
            eps = torch.where(back, eps * s["backoff"], eps)
            run = torch.where(acc | back, torch.zeros_like(run), run)
        return eps, sigma


PROBLEM = LatentProblem
