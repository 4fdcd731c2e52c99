"""Nonlinear (learned) blur operator (port of
nshmc_tpu/operators/nonlinear_blur.py).

H blurs with a kernel-conditioned network and a fixed random kernel code
randn(1, 2, 2, kernel_dim) * 1.2, mapping [-1, 1] -> [0, 1] -> blur ->
[-1, 1] clipped. Two networks, as in the JAX package:
  - `create_bkse(state_dict)`: the real bkse KernelWizard
    (models/kernel_wizard.py), from a torch checkpoint or random weights;
  - `create()`: a small surrogate (`KernelAdapter`) with random weights,
    the default of `build_operator("deblur_nonlinear")`.

Deviation, stated: the JAX package draws the kernel code and the random
weights from `PRNGKey(seed)`, whose threefry stream torch cannot reproduce.
Here they come from a `torch.Generator` seeded `seed` (the bkse weights from
one seeded `seed + 1`, as the JAX package's key is), with the JAX package's
initialisers' scales, so the two packages' operators differ for the same
seed. `NonlinearBlur.from_jax` takes a JAX operator's kernel code and
parameters (as numpy) and gives the same H.

The kernel code is kept NHWC, (1, 2, 2, kernel_dim): the surrogate's FiLM
layers flatten it in (h, w, c) order, as the JAX package's Dense does; the
bkse network takes it as NCHW.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.kernel_wizard import KernelWizard, KernelWizardConfig, state_dict_from_jax
from .base import Operator


class KernelAdapter(nn.Module):
    """Kernel-conditioned blur surrogate (nshmc_tpu/operators/nonlinear_blur.py:38-63):
    x (B, 3, H, W) in [0, 1] and the kernel code (B, 2, 2, kernel_dim) ->
    the blurred image (B, 3, H, W)."""

    def __init__(self, nf: int = 32, kernel_dim: int = 512, channels: int = 3):
        super().__init__()
        self.conv0 = nn.Conv2d(channels, nf, 5, padding=2)
        self.conv1 = nn.Conv2d(nf, 2 * nf, 3, stride=2, padding=1)
        self.scale = nn.Linear(4 * kernel_dim, 2 * nf)
        self.shift = nn.Linear(4 * kernel_dim, 2 * nf)
        self.conv2 = nn.Conv2d(2 * nf, 2 * nf, 3, padding=1)
        self.conv3 = nn.Conv2d(2 * nf, nf, 3, padding=1)
        self.conv4 = nn.Conv2d(nf, channels, 5, padding=2)

    def forward(self, x, kernel):
        h = F.silu(self.conv1(F.silu(self.conv0(x))))
        code = kernel.reshape(kernel.shape[0], -1)  # (h, w, c) order
        scale = self.scale(code)[:, :, None, None]
        shift = self.shift(code)[:, :, None, None]
        h = h * (1 + torch.tanh(scale)) + 0.1 * torch.tanh(shift)
        h = F.silu(self.conv2(h))
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        return x + self.conv4(F.silu(self.conv3(h)))

    def flax_names(self):
        """(module, flax name) pairs: the JAX surrogate's auto-naming."""
        return ((self.conv0, "Conv_0"), (self.conv1, "Conv_1"), (self.scale, "Dense_0"),
                (self.shift, "Dense_1"), (self.conv2, "Conv_2"), (self.conv3, "Conv_3"),
                (self.conv4, "Conv_4"))


@torch.no_grad()
def init_like_flax(net: nn.Module, generator: torch.Generator, small=()):
    """Random weights from `generator` at flax's default scales: every conv
    and dense kernel N(0, 1 / fan_in) with fan_in the flax one (kernel
    height x width x input channels), biases 0; the modules in `small`
    N(0, 1e-3^2), as the JAX surrogate's last conv."""
    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            cin = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]
            fan_in = cin * math.prod(w.shape[2:])
            std = 1e-3 if mod in small else 1.0 / math.sqrt(fan_in)
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            if mod.bias is not None:
                mod.bias.zero_()


def _frozen(net: nn.Module, device) -> nn.Module:
    """`net` on `device` in eval mode, its weights out of autograd: H is
    differentiated in its input only."""
    return net.to(device).eval().requires_grad_(False)


class NonlinearBlur(Operator):
    """y = clip(2 blur((x + 1) / 2, code) - 1, -1, 1)
    (nshmc_tpu/operators/nonlinear_blur.py:66-154)."""

    def __init__(self, kernel_code, net: nn.Module, channels: int = 3, img_dim: int = 256,
                 device="cuda"):
        self.kernel_code = torch.tensor(np.array(kernel_code, np.float32), device=device)
        self.net = _frozen(net, device)
        self.bkse = isinstance(net, KernelWizard)
        self.channels, self.img_dim = channels, img_dim

    @classmethod
    def create(cls, channels: int = 3, img_dim: int = 256, seed: int = 0, nf: int = 32,
               wizard: KernelWizard | None = None,
               wizard_cfg: KernelWizardConfig = KernelWizardConfig(),
               device="cuda") -> "NonlinearBlur":
        """The random surrogate, or the given bkse `wizard` network; the
        kernel code from a generator seeded `seed`."""
        g = torch.Generator().manual_seed(seed)
        kernel = torch.randn((1, 2, 2, wizard_cfg.kernel_dim), generator=g) * 1.2
        if wizard is None:
            wizard = KernelAdapter(nf, wizard_cfg.kernel_dim, channels)
            init_like_flax(wizard, g, small=(wizard.conv4,))
        return cls(kernel, wizard, channels, img_dim, device)

    @classmethod
    def create_bkse(cls, state_dict=None, channels: int = 3, img_dim: int = 256, seed: int = 0,
                    wizard_cfg: KernelWizardConfig = KernelWizardConfig(),
                    device="cuda") -> "NonlinearBlur":
        """The real bkse KernelWizard: a torch checkpoint's `state_dict`
        (loaded strictly), or random weights from a generator seeded
        `seed + 1`."""
        wizard = KernelWizard(wizard_cfg)
        if state_dict is not None:
            wizard.load_state_dict(state_dict, strict=True)
        else:
            init_like_flax(wizard, torch.Generator().manual_seed(seed + 1))
        return cls.create(channels, img_dim, seed, wizard=wizard, wizard_cfg=wizard_cfg,
                          device=device)

    @classmethod
    def from_jax(cls, kernel_code, params, channels: int = 3, img_dim: int = 256,
                 nf: int = 32, net: str = "surrogate",
                 wizard_cfg: KernelWizardConfig = KernelWizardConfig(),
                 device="cuda") -> "NonlinearBlur":
        """The JAX operator's kernel code (1, 2, 2, kernel_dim) and network
        parameters (its `blur_params`, as numpy), `net` "surrogate" or
        "bkse" as its `_net`: the same H in this package. A bkse tree that
        holds only what `adapt_kernel` uses leaves the kernel extractor, which
        H does not run, at its initial weights."""
        kernel_code = np.asarray(kernel_code, np.float32)
        if net == "bkse":
            wizard = KernelWizard(wizard_cfg)
            missing, unexpected = wizard.load_state_dict(state_dict_from_jax(params, wizard_cfg),
                                                         strict=False)
            if unexpected or any(not k.startswith("kernel_extractor.") for k in missing):
                raise KeyError(f"JAX parameters do not fit the KernelWizard: missing {missing}, "
                               f"unexpected {unexpected}")
        else:
            wizard = KernelAdapter(nf, kernel_code.shape[-1], channels)
            p = params.get("params", params)
            with torch.no_grad():
                for mod, name in wizard.flax_names():
                    k = np.asarray(p[name]["kernel"])
                    k = k.T if isinstance(mod, nn.Linear) else np.transpose(k, (3, 2, 0, 1))
                    mod.weight.copy_(torch.tensor(np.array(k, np.float32)))
                    mod.bias.copy_(torch.tensor(np.array(p[name]["bias"], np.float32)))
        return cls(kernel_code, wizard, channels, img_dim, device)

    def is_linear(self):
        return False

    def _blur(self, img01):
        code = self.kernel_code.expand((img01.shape[0],) + self.kernel_code.shape[1:])
        if self.bkse:
            return self.net.adapt_kernel(img01, code.permute(0, 3, 1, 2))
        return self.net(img01, code)

    def H(self, vec):
        b, d = vec.shape[0], self.img_dim
        img01 = (vec.reshape(b, self.channels, d, d).float() + 1.0) / 2.0
        return torch.clamp(self._blur(img01) * 2.0 - 1.0, -1.0, 1.0).reshape(b, -1)

    def H_pinv(self, vec):
        """Identity, as in the reference."""
        return vec.reshape(vec.shape[0], -1)
