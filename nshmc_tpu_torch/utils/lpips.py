"""LPIPS perceptual metric on a VGG16 backbone (port of
nshmc_tpu/utils/lpips.py).

The reference reports LPIPS from the `lpips` package with net='vgg': VGG16
feature stacks at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each
normalised per position over its channels as x / sqrt(sum x^2 + 1e-10),
squared differences through learned 1x1 heads, averaged over space and
summed; inputs are shifted and scaled channel by channel first.

  - `VGG16Features.features` has torchvision's `vgg16().features` layout
    (convs at indices 0, 2, 5, ..., 28), so torchvision's `features.*`
    weights load into it unchanged; the heads are `lin{i}.model.1`, the
    `lpips` package's keys.
  - Inputs are NHWC in [-1, 1], as in the JAX package; the distance is
    (B,) float32. Plain torch (cuDNN convolutions on the card).
  - `try_load_lpips` reads two local files and nothing else: it never
    downloads. Unlike the JAX helper, which asks torchvision for
    IMAGENET1K_V1 weights (a download when they are not cached) and
    swallows every exception, it returns None only when a file is absent
    and lets any other failure raise.
"""
from __future__ import annotations

import importlib.machinery
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

# VGG16 conv plan: (out_channels, n_convs) per stage; max pool between stages
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# torchvision vgg16.features indices of the 13 convs
TV_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
# lpips' ScalingLayer
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)
# torchvision's cache file of vgg16(weights="IMAGENET1K_V1"), under
# torch.hub.get_dir()/checkpoints, and the lpips package's VGG heads
VGG16_FILE = "vgg16-397923af.pth"
LPIPS_HEADS = os.path.join("weights", "v0.1", "vgg.pth")


class VGG16Features(nn.Module):
    """VGG16 to relu5_3; forward returns the five LPIPS feature stacks."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        in_ch = 3
        for stage, (ch, n) in enumerate(_VGG_STAGES):
            for _ in range(n):
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
            if stage != len(_VGG_STAGES) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        # each stage's last ReLU
        self._taps = {i for i, m in enumerate(layers) if isinstance(m, nn.ReLU) and (
            i + 1 == len(layers) or isinstance(layers[i + 1], nn.MaxPool2d))}

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                feats.append(x)
        return feats


class _Head(nn.Module):
    """lpips' NetLinLayer: model.0 the (inert) dropout, model.1 the 1x1
    bias-free conv to one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """forward(a, b): LPIPS-VGG distance between NHWC images in [-1, 1]
    -> (B,) float32."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_STAGES):
            setattr(self, f"lin{i}", _Head(ch))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = a.shape[0]
        x = torch.cat([a, b]).permute(0, 3, 1, 2).float()
        feats = self.vgg((x - self.shift) / self.scale)
        total = torch.zeros(n, device=a.device)
        for i, f in enumerate(feats):
            f = f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{i}").model[1]
            total = total + lin((f[:n] - f[n:]) ** 2).mean(dim=(1, 2, 3))
        return total


def port_lpips_weights(vgg_sd, lin_sd) -> Dict[str, torch.Tensor]:
    """torchvision VGG16 `features.*` weights + lpips `lin{i}.model.1.weight`
    heads -> an LPIPS state_dict (float32). Raises KeyError on a missing
    key; other entries (torchvision's classifier) are ignored."""
    sd = {}
    for idx in TV_CONV_IDX:
        for p in ("weight", "bias"):
            sd[f"vgg.features.{idx}.{p}"] = torch.as_tensor(vgg_sd[f"features.{idx}.{p}"]).float()
    for i in range(len(_VGG_STAGES)):
        key = f"lin{i}.model.1.weight"
        sd[key] = torch.as_tensor(lin_sd[key]).float()
    return sd


def weight_files() -> tuple:
    """(VGG16 file, heads file) where `try_load_lpips` looks: torchvision's
    cache under torch.hub.get_dir() (TORCH_HOME), and the installed lpips
    package's weights/v0.1/vgg.pth (None where the package is absent). The
    package is located on sys.path, never imported; a module of that name
    already in sys.modules (a stand-in without a spec) is not consulted."""
    vgg = os.path.join(torch.hub.get_dir(), "checkpoints", VGG16_FILE)
    spec = importlib.machinery.PathFinder.find_spec("lpips")
    dirs = list(spec.submodule_search_locations or []) if spec else []
    return vgg, (os.path.join(dirs[0], LPIPS_HEADS) if dirs else None)


def try_load_lpips(device="cuda") -> Optional[LPIPS]:
    """The LPIPS-VGG metric with the reference's weights, read from local
    files only (`weight_files`), on `device`; None when either file is
    absent. Any other failure (a corrupt file, missing keys, a device
    error) raises."""
    vgg_path, heads_path = weight_files()
    if not (os.path.isfile(vgg_path) and heads_path and os.path.isfile(heads_path)):
        return None
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    lin_sd = torch.load(heads_path, map_location="cpu", weights_only=True)
    model = LPIPS()
    model.load_state_dict(port_lpips_weights(vgg_sd, lin_sd), strict=True)
    return model.to(device).eval()
