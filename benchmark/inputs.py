"""The inputs every run makes from its --seed, on the device, the same for
the program and for the reference: seeded weights, a synthetic image, the
inpainting mask, y0's noise, the chains' start and each attempt's draws.

Weights follow chip_smoke.py::random_state_dict's rules (copied): a matrix
or kernel N(0, 1/fan_in), with the layers the published models
zero-initialise (ResBlock and attention output projections, the final conv)
drawn 20x smaller, so every activation and gradient is live while the
network stays near the residual identity; a GroupNorm scale 1 + 0.1 N(0, 1);
any other vector 0.05 N(0, 1). Unlike that function they are drawn on the
device in one call per model, from a torch.Generator on the card."""
from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = ("weights", "image", "mask", "noise", "start", "draws", "check")


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one named stream of a run, from --seed (any
    non-negative whole number, 32 bits or more)."""
    ss = np.random.SeedSequence([int(seed), STREAMS.index(stream), int(index)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, stream: str, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream, index))


def _small(name: str) -> bool:
    return ".out_layers.3." in name or ".proj_out." in name or name.startswith("out.2.")


def random_state_dict(shapes: dict, device, seed: int, index: int = 0) -> dict:
    """{name: float32 tensor} for {name: shape}, drawn from one standard
    normal block on `device`; `index` tells the models of one run apart."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = generator(device, seed, "weights", index)
    block = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for name, part in zip(names, torch.split(block, sizes)):
        shape = tuple(shapes[name])
        t = part.view(shape)
        if len(shape) > 1:
            fan_in = math.prod(shape[1:])
            t.mul_((0.05 if _small(name) else 1.0) / math.sqrt(fan_in))
        elif name.endswith("weight"):  # a GroupNorm scale
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.05)
        out[name] = t
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def synthetic_image(size: int, seed: int, index: int = 0) -> np.ndarray:
    """(size, size, 3) float32 in [0, 1]: smooth bands plus a little noise
    (chip_smoke.py::synthetic_image's picture, seeded per image)."""
    rng = np.random.default_rng(sub_seed(seed, "image", index))
    yy, xx = np.mgrid[:size, :size] / size
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx + 2 * yy), 0.5 + 0.4 * np.cos(5 * yy),
                    0.5 + 0.3 * np.sin(9 * xx * yy)], -1)
    return np.clip(img + 0.03 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)


def mask_rng(seed: int) -> np.random.Generator:
    """The numpy generator the operator's draws (an inpainting mask) come
    from, for the program's operator and the reference's alike (the CLIs
    draw theirs from np.random.default_rng(--seed) the same way)."""
    return np.random.default_rng(sub_seed(seed, "mask"))


def normal(shape, device, seed: int, stream: str, index: int = 0) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator(device, seed, stream, index),
                       device=device)


class Draws:
    """Each attempt's unit-normal momenta (N, ...) and accept uniforms (N,),
    in the engine's order (all momenta, then the uniforms), from one device
    generator per image; `on_draw(p0, u)`, where set, sees each pair."""

    def __init__(self, shape, device, seed: int, index: int):
        self.shape, self.device = tuple(shape), device
        self.g = generator(device, seed, "draws", index)
        self.on_draw = None

    def __iter__(self):
        return self

    def __next__(self):
        p0 = torch.randn(self.shape, generator=self.g, device=self.device)
        u = torch.rand((self.shape[0],), generator=self.g, device=self.device)
        if self.on_draw is not None:
            self.on_draw(p0, u)
        return p0, u
