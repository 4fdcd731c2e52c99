"""bkse KernelWizard blur network (port of nshmc_tpu/models/kernel_wizard.py).

The reference's nonlinear-blur operator wraps this pretrained
kernel-conditioned network (the public VinAIResearch/blur-kernel-space-
exploring project, models/kernel_encoding/kernel_wizard.py). Here it is a
set of `nn.Module`s, NCHW, whose `state_dict` keys ARE the bkse keys
(`feature_extractor.6.3.conv1.weight`, `adapter.model.submodule.down.1.weight`,
`kernel_extractor.model.19.conv_block.5.weight`, `recon_trunk.11.conv2.bias`,
...), so a real checkpoint loads with `load_state_dict(strict=True)` and no
conversion. Parameterless layers (Identity norms, ReLU, ReflectionPad) sit at
their bkse positions so that the Sequential indices match.

`state_dict_from_jax(params, cfg)` is the inverse of the JAX package's
`port_kernel_wizard`: it maps the JAX parameter tree to this module's keys.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class KernelWizardConfig:
    """bkse options/generate_blur/default.yml `KernelWizard:`."""

    input_nc: int = 3
    nf: int = 64
    front_RBs: int = 10
    back_RBs: int = 20
    kernel_dim: int = 512
    use_vae: bool = False
    adapter_ngf: int = 64
    adapter_tanh: bool = True  # pix2pix keeps a Tanh on the outermost up path
    extractor_n_blocks: int = 4
    extractor_use_sharp: bool = True


# Sequential positions of the convolutions (the bkse layouts below)
FE_CONVS = (0, 2, 4)  # feature_extractor: [conv, lrelu] x 3, then the resblocks
FE_RBS = 6
EXT_HEAD = 1  # kernel_extractor.model: [pad, conv, Identity, ReLU]
EXT_DOWNS = tuple(4 + 3 * i for i in range(5))  # [conv, Identity, ReLU] x 5
EXT_RES0 = 19  # then the resnet blocks
RES_CONVS = (1, 5)  # conv_block: [pad, conv, Identity, ReLU, pad, conv, Identity]
UP_CONV = 1  # up: [ReLU, upconv, Tanh | Identity]


def _down_conv_index(depth: int) -> int:
    """down: [downconv] outermost, [LeakyReLU, downconv, ...] below it."""
    return 0 if depth == 0 else 1


class ResidualBlockNoBN(nn.Module):
    """EDVR arch_util.ResidualBlock_noBN: x + conv2(relu(conv1(x)))."""

    def __init__(self, nf: int):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, nf, 3, 1, 1, bias=True)
        self.conv2 = nn.Conv2d(nf, nf, 3, 1, 1, bias=True)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x)))


class UnetSkipBlock(nn.Module):
    """bkse's kernel-threading pix2pix UnetSkipConnectionBlock with
    norm='none': Identity norms, bias-free convolutions except the outermost
    upconv. The innermost block concatenates the kernel code with its 2x2
    bottleneck features. The upconv is `ConvTranspose2d(4, 2, 1)`."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: int | None = None,
                 submodule: "UnetSkipBlock | None" = None, outermost: bool = False,
                 innermost: bool = False, use_tanh: bool = True):
        super().__init__()
        self.outermost, self.innermost = outermost, innermost
        downconv = nn.Conv2d(input_nc or outer_nc, inner_nc, 4, 2, 1, bias=False)
        upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1, bias=outermost)
        if outermost:
            down = [downconv]
            up = [nn.ReLU(), upconv] + ([nn.Tanh()] if use_tanh else [])
        elif innermost:
            down = [nn.LeakyReLU(0.2), downconv]
            up = [nn.ReLU(), upconv, nn.Identity()]
        else:
            down = [nn.LeakyReLU(0.2), downconv, nn.Identity()]
            up = [nn.ReLU(), upconv, nn.Identity()]
        self.down = nn.Sequential(*down)
        self.submodule = submodule
        self.up = nn.Sequential(*up)

    def forward(self, x, k):
        h = self.down(x)
        h = torch.cat([h, k.to(h.dtype)], dim=1) if self.innermost else self.submodule(h, k)
        h = self.up(h)
        return h if self.outermost else torch.cat([x, h], dim=1)


class KernelAdapterNet(nn.Module):
    """The function F of the bkse paper: a 5-level U-Net over the features,
    the kernel code (kernel_dim, 2, 2) injected at the 2x2 bottleneck."""

    def __init__(self, nf: int, ngf: int, use_tanh: bool = True):
        super().__init__()
        blk = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True)
        blk = UnetSkipBlock(ngf * 4, ngf * 8, submodule=blk)
        blk = UnetSkipBlock(ngf * 2, ngf * 4, submodule=blk)
        blk = UnetSkipBlock(ngf, ngf * 2, submodule=blk)
        self.model = UnetSkipBlock(nf, ngf, input_nc=nf, submodule=blk, outermost=True,
                                   use_tanh=use_tanh)

    def forward(self, x, k):
        return self.model(x, k)


class ResnetBlockReflect(nn.Module):
    """pix2pix ResnetBlock with reflection padding and Identity norms."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=False), nn.Identity(), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=False), nn.Identity())

    def forward(self, x):
        return x + self.conv_block(x)


class KernelExtractor(nn.Module):
    """bkse KernelExtractor (the blur-kernel encoder): a reflect-padded 7x7
    conv, 5 strided convs capped at the code's channels, resnet blocks."""

    def __init__(self, cfg: KernelWizardConfig):
        super().__init__()
        out_nc = cfg.kernel_dim * 2 if cfg.use_vae else cfg.kernel_dim
        in_nc = cfg.nf * 2 if cfg.extractor_use_sharp else cfg.nf
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(in_nc, cfg.nf, 7, padding=0, bias=False),
                  nn.Identity(), nn.ReLU()]
        for i in range(5):
            inc, ouc = min(cfg.nf * 2**i, out_nc), min(cfg.nf * 2 ** (i + 1), out_nc)
            layers += [nn.Conv2d(inc, ouc, 3, stride=2, padding=1, bias=False), nn.Identity(),
                       nn.ReLU()]
        layers += [ResnetBlockReflect(out_nc) for _ in range(cfg.extractor_n_blocks)]
        self.model = nn.Sequential(*layers)

    def forward(self, feats):
        return self.model(feats)


class KernelWizard(nn.Module):
    """The full wizard. `adapt_kernel` is the path the reference operator
    uses (blur_model.adaptKernel(data, kernel)); `forward` estimates the
    kernel code of a (sharp, blur) pair. Images are NCHW in [0, 1]."""

    def __init__(self, cfg: KernelWizardConfig = KernelWizardConfig()):
        super().__init__()
        self.cfg = cfg
        nf = cfg.nf
        lrelu = nn.LeakyReLU(0.1)
        self.feature_extractor = nn.Sequential(
            nn.Conv2d(cfg.input_nc, nf, 3, 1, 1, bias=True), lrelu,
            nn.Conv2d(nf, nf, 3, 2, 1, bias=True), lrelu,
            nn.Conv2d(nf, nf, 3, 2, 1, bias=True), lrelu,
            nn.Sequential(*[ResidualBlockNoBN(nf) for _ in range(cfg.front_RBs)]))
        self.kernel_extractor = KernelExtractor(cfg)
        self.adapter = KernelAdapterNet(nf, cfg.adapter_ngf, cfg.adapter_tanh)
        self.recon_trunk = nn.Sequential(*[ResidualBlockNoBN(nf) for _ in range(cfg.back_RBs)])
        self.upconv1 = nn.Conv2d(nf, nf * 4, 3, 1, 1, bias=True)
        self.upconv2 = nn.Conv2d(nf, 64 * 4, 3, 1, 1, bias=True)
        self.pixel_shuffle = nn.PixelShuffle(2)
        self.HRconv = nn.Conv2d(64, 64, 3, 1, 1, bias=True)
        self.conv_last = nn.Conv2d(64, cfg.input_nc, 3, 1, 1, bias=True)
        self.lrelu = nn.LeakyReLU(0.1)

    def adapt_kernel(self, x_sharp, kernel):
        """x_sharp (B, C, H, W) in [0, 1], kernel (B, kernel_dim, 2, 2) ->
        the re-blurred image (B, C, H, W)."""
        h = self.adapter(self.feature_extractor(x_sharp), kernel)
        h = self.recon_trunk(h)
        h = self.lrelu(self.pixel_shuffle(self.upconv1(h)))
        h = self.lrelu(self.pixel_shuffle(self.upconv2(h)))
        return self.conv_last(self.lrelu(self.HRconv(h))) + x_sharp

    def forward(self, x_sharp, x_blur):
        """(mu, logvar) of the kernel code; logvar is zeros without the VAE."""
        fb = self.feature_extractor(x_blur)
        feats = (torch.cat([self.feature_extractor(x_sharp), fb], dim=1)
                 if self.cfg.extractor_use_sharp else fb)
        h = self.kernel_extractor(feats)
        if self.cfg.use_vae:
            return h[:, : self.cfg.kernel_dim], h[:, self.cfg.kernel_dim:]
        return h, torch.zeros_like(h)


def _conv(hwio) -> torch.Tensor:
    """Flax conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return torch.tensor(np.array(np.transpose(np.asarray(hwio), (3, 2, 0, 1)), np.float32))


def _conv_t(hwio_flipped) -> torch.Tensor:
    """The JAX package's flipped dilated-conv kernel (kh, kw, in, out) ->
    torch ConvTranspose2d (in, out, kh, kw), unflipped."""
    w = np.transpose(np.asarray(hwio_flipped), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return torch.tensor(np.array(w, np.float32))


def _vec(a) -> torch.Tensor:
    return torch.tensor(np.array(a, np.float32))


def state_dict_from_jax(params, cfg: KernelWizardConfig = KernelWizardConfig()) -> dict:
    """The JAX package's KernelWizard parameters ({"params": ...} or the
    inner tree, arrays or numpy) as this module's state_dict, with the bkse
    keys: the inverse of nshmc_tpu/models/kernel_wizard.py::port_kernel_wizard.
    A tree initialised for `adapt_kernel` alone has no kernel extractor, and
    then the result has no `kernel_extractor.*` keys."""
    p = params.get("params", params)
    sd = {}

    def put(key, leaf, bias=True):
        sd[f"{key}.weight"] = _conv(leaf["kernel"])
        if bias:
            sd[f"{key}.bias"] = _vec(leaf["bias"])

    for j, ix in enumerate(FE_CONVS):
        put(f"feature_extractor.{ix}", p[f"fe_conv{j}"])
    for i in range(cfg.front_RBs):
        for conv in ("conv1", "conv2"):
            put(f"feature_extractor.{FE_RBS}.{i}.{conv}", p[f"fe_rb{i}"][conv])
    node = p["adapter"]
    for depth in range(5):
        node = node[f"b{depth}"]
        prefix = "adapter.model." + "submodule." * depth
        put(f"{prefix}down.{_down_conv_index(depth)}", node["downconv"], bias=False)
        sd[f"{prefix}up.{UP_CONV}.weight"] = _conv_t(node["upconv"]["kernel"])
        if depth == 0:  # only the outermost upconv has a bias
            sd[f"{prefix}up.{UP_CONV}.bias"] = _vec(node["upconv"]["bias"])
    ext = p.get("extractor")  # absent from a tree initialised for adapt_kernel alone
    if ext is not None:
        put(f"kernel_extractor.model.{EXT_HEAD}", ext["head"], bias=False)
        for i, ix in enumerate(EXT_DOWNS):
            put(f"kernel_extractor.model.{ix}", ext[f"down{i}"], bias=False)
        for i in range(cfg.extractor_n_blocks):
            for conv, ix in zip(("conv1", "conv2"), RES_CONVS):
                put(f"kernel_extractor.model.{EXT_RES0 + i}.conv_block.{ix}",
                    ext[f"res{i}"][conv], bias=False)
    for i in range(cfg.back_RBs):
        for conv in ("conv1", "conv2"):
            put(f"recon_trunk.{i}.{conv}", p[f"rt_rb{i}"][conv])
    for key, name in (("upconv1", "upconv1"), ("upconv2", "upconv2"), ("HRconv", "hr_conv"),
                      ("conv_last", "conv_last")):
        put(key, p[name])
    return sd
