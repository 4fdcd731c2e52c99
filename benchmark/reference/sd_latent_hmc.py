"""The Stable Diffusion latent cell's reference: SD 2's conditional eps-net
(reference/sd_unet.py) held constant (no gradient through it) in the 3-step
DDIM ladder, one prompt's context shared by every chain, no guidance,
z_T -> z_0 -> KL-f8 decode of z_0 / scale_factor (reference/kl.py) ->
image -> H; and the latent sampler's schedule (reference/latent_hmc.py).

The context is a (1, 77, context_dim) standard normal draw standing for a
prompt's text-encoder output (77 tokens: the text encoder's length). It reaches both sides through the weights:
`Context` is the third model of the problem (weights index 2), a vector
drawn by inputs.random_state_dict (0.05 N(0, 1), that function's rule for
a vector not named `weight`) and divided by 0.05; the program's side
(systems/sd_latent_hmc.py) draws it through the same module.

`SDProblem.islands`, where set to a dtype (a control's, with the bfloat16
numerics: tests/readings_islands.py), runs the configuration's float32
islands, GroupNorm, LayerNorm and softmax, in that dtype (`islands_in`)."""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ddim
from .kl import KLDecode
from .latent_hmc import LatentProblem
from .problems import Problem
from .sd_unet import SDSpec, SDUNet
from .unet import UNetSpec
from .vq import VQSpec

CONTEXT_INDEX = 2  # the context's weights index: its place in PROBLEM.models
CONTEXT_TOKENS = 77  # the text encoder's sequence length (FrozenOpenCLIPEmbedder's max_length)
VECTOR_SCALE = 0.05  # inputs.random_state_dict's scale of a vector not named weight


def islands_in(dtype: torch.dtype):
    """Within the block, F.group_norm, F.layer_norm and torch.softmax (the
    reference's float32 islands, here and in the blocks it imports) compute
    as `dtype` operations do: every step's result rounded to `dtype` (the
    input, the mean, the centred values, the variance, its rsqrt, the
    normalised values, the affine; the shifted logits, their exp, the sum,
    the quotient), each reduction summed in float32. They return float32,
    as the islands do."""
    r = lambda t: t.to(dtype).float()  # noqa: E731

    def normalized(x, dims, eps):
        mean = r(x.mean(dims, keepdim=True))
        xc = r(x - mean)
        var = r(r(xc * xc).mean(dims, keepdim=True))
        return r(xc * r(torch.rsqrt(r(var + eps))))

    def group_norm(x, num_groups, weight=None, bias=None, eps=1e-5):
        y = normalized(r(x).reshape(x.shape[0], num_groups, -1), -1, eps).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return r(y * r(weight).view(shape) + r(bias).view(shape))

    def layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5):
        dims = tuple(range(-len(normalized_shape), 0))
        return r(normalized(r(x), dims, eps) * r(weight) + r(bias))

    def softmax(x, dim, dtype=None):
        x = r(x)
        e = r(torch.exp(r(x - x.amax(dim, keepdim=True))))
        return r(e / r(e.sum(dim, keepdim=True)))

    @contextlib.contextmanager
    def scope():
        saved = F.group_norm, F.layer_norm, torch.softmax
        F.group_norm, F.layer_norm, torch.softmax = group_norm, layer_norm, softmax
        try:
            yield
        finally:
            F.group_norm, F.layer_norm, torch.softmax = saved

    return scope()


class Context(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.shape = (1, CONTEXT_TOKENS, width)
        self.register_buffer("context", torch.zeros(CONTEXT_TOKENS * width))

    def value(self) -> torch.Tensor:
        return (self.context / VECTOR_SCALE).view(self.shape)


def sd_unet_spec(m: dict) -> SDSpec:
    u = m["unet"]
    return SDSpec(UNetSpec(image_size=m["image_size"], in_channels=u["in_channels"],
                           model_channels=u["model_channels"], out_channels=u["out_channels"],
                           num_res_blocks=u["num_res_blocks"],
                           attention_ds=tuple(u["attention_resolutions"]),
                           channel_mult=tuple(u["channel_mult"]),
                           num_head_channels=u["num_head_channels"],
                           use_scale_shift_norm=False, resblock_updown=False),
                  context_dim=u["context_dim"], depth=u["transformer_depth"])


def kl_spec(fs: dict) -> VQSpec:
    return VQSpec(ch=fs["ch"], ch_mult=tuple(fs["ch_mult"]), num_res_blocks=fs["num_res_blocks"],
                  z_channels=fs["z_channels"], embed_dim=fs["embed_dim"], n_embed=0)


class SDProblem(LatentProblem):
    islands = None  # float32 islands as configured; a dtype: islands_in(dtype)

    def __init__(self, config, traffic, op, device):
        Problem.__init__(self, config, traffic, op, device)
        m = config["model"]
        self.unet = SDUNet(sd_unet_spec(m)).to(device)
        self.kl = KLDecode(kl_spec(m["first_stage"]), m["scale_factor"]).to(device)
        self.context = Context(m["unet"]["context_dim"]).to(device)
        self.models = [self.unet, self.kl, self.context]
        self.ac = ddim.alphas_cumprod("quad", m["linear_start"], m["linear_end"], m["timesteps"])
        self.pairs = ddim.ladder(m["timesteps"], config["ddim_steps"])

    def decoded(self, z):
        """(z_0, image); the forward and a checkpoint's recompute both run
        here, so `islands` covers the backward too."""
        with islands_in(self.islands) if self.islands else contextlib.nullcontext():
            ctx = self.context.value()
            eps = lambda x, t: self.unet(x, t, ctx.expand(len(x), -1, -1))  # noqa: E731
            z0 = ddim.decode(eps, self.ac, self.pairs, z, eps_grad=False)
            return z0, self.kl(z0)

    def flips(self, dec_a, dec_b):
        """Latent elements that the ladder's clip to [-1, 1] holds in one z_0
        and not in the other (no quantizer: the KL decode is continuous)."""
        held = lambda d: d.abs() >= 1.0  # noqa: E731
        return [int(v) for v in (held(dec_a) ^ held(dec_b)).reshape(len(dec_a), -1).sum(1)]


PROBLEM = SDProblem
