"""Forward operators and the degradation registry (port of
nshmc_tpu/operators/__init__.py): every degradation of the JAX package.
As there, the sigma_0 doubling for the [-1, 1] range is the caller's job."""
from __future__ import annotations

import numpy as np

from .base import Operator, SVDOperator, flatten_image, unflatten_image
from .linear import (Colorization, Denoising, Inpainting, SuperResolution,
                     box_inpainting_indices, random_inpainting_indices)
from .deblur import Deblurring, Deblurring2D, SRConv
from .cs import WalshHadamardCS, fwht
from .nonlinear import HDR, PhaseRetrieval, fft2c, ifft2c, set_fft_impl
from .general import GeneralH

__all__ = [
    "Operator", "SVDOperator", "flatten_image", "unflatten_image",
    "Inpainting", "Denoising", "SuperResolution", "Colorization",
    "Deblurring", "Deblurring2D", "SRConv", "WalshHadamardCS",
    "PhaseRetrieval", "HDR", "GeneralH", "NonlinearBlur",
    "random_inpainting_indices", "box_inpainting_indices",
    "build_operator", "fwht", "fft2c", "ifft2c", "set_fft_impl",
]


def NonlinearBlur(*args, **kwargs):
    """`nonlinear_blur.NonlinearBlur.create(*args, **kwargs)`."""
    from .nonlinear_blur import NonlinearBlur as _NB

    return _NB.create(*args, **kwargs)


def build_operator(deg: str, channels: int = 3, img_dim: int = 256,
                   rng: np.random.Generator | None = None, device="cuda"):
    """Build a forward operator from a degradation string, in the JAX
    package's order and with its draws from the numpy `rng` (default seeded
    0), so inpainting masks and CS permutations equal the JAX ones
    (nshmc_tpu/operators/__init__.py:43-91). Raises ValueError for a string
    that names no degradation."""
    rng = rng or np.random.default_rng(0)

    if "sr" in deg:
        if deg.startswith("sr_bicubic"):
            return SRConv.bicubic(channels, img_dim, int(deg[len("sr_bicubic"):]),
                                  device=device)
        return SuperResolution.create(channels, img_dim, int(deg[2:]), device=device)
    if "inp" in deg:
        if "box" in deg:
            left = int(rng.integers(16, 113))
            up = int(rng.integers(16, 113))
            missing = box_inpainting_indices(img_dim, channels, left, up)
        else:
            perm = rng.permutation(img_dim**2)[: int(img_dim**2 * 0.92)]
            missing_r = 3 * perm
            missing = np.sort(np.concatenate([missing_r, missing_r + 1, missing_r + 2]))
        return Inpainting(channels, img_dim, missing, device=device)
    if "deblur_gauss" in deg:
        return Deblurring.gaussian(channels, img_dim, sigma=10.0, device=device)
    if "phase" in deg:
        return PhaseRetrieval.create(channels, img_dim, oversample=2.0, device=device)
    if "hdr" in deg:
        return HDR.create(channels, img_dim, device=device)
    if "cs" in deg:
        return WalshHadamardCS.create(channels, img_dim, int(deg[2:]),
                                      rng.permutation(img_dim**2), device=device)
    if deg == "deblur_aniso":
        return Deblurring2D.aniso(channels, img_dim, device=device)
    if deg == "deblur_nonlinear":
        return NonlinearBlur(channels=channels, img_dim=img_dim, device=device)
    if deg == "color":
        return Colorization.create(img_dim, device=device)
    if deg == "denoise":
        return Denoising.create(channels, img_dim, device=device)
    raise ValueError(f"degradation type not supported: {deg}")
