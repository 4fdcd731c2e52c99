"""Forward operators and the degradation registry (port of
nshmc_tpu/operators/__init__.py). Only inpainting is ported so far; the
other degradations are queued in ROADMAP.md. As in the JAX package, the
sigma_0 doubling for the [-1, 1] range is the caller's job."""
from __future__ import annotations

import numpy as np

from .base import SVDOperator, flatten_image, unflatten_image
from .linear import Inpainting, box_inpainting_indices

__all__ = ["SVDOperator", "flatten_image", "unflatten_image", "Inpainting",
           "box_inpainting_indices", "build_operator"]


def build_operator(deg: str, channels: int = 3, img_dim: int = 256,
                   rng: np.random.Generator | None = None, device="cuda"):
    """Build a forward operator from a degradation string
    (nshmc_tpu/operators/__init__.py:43-91). Randomized masks draw from the
    numpy `rng` (default seeded 0), so the port's mask equals the JAX one."""
    rng = rng or np.random.default_rng(0)
    if "inp" in deg and "sr" not in deg:
        if "box" in deg:
            left = int(rng.integers(16, 113))
            up = int(rng.integers(16, 113))
            missing = box_inpainting_indices(img_dim, channels, left, up)
        else:
            perm = rng.permutation(img_dim**2)[: int(img_dim**2 * 0.92)]
            missing_r = 3 * perm
            missing = np.sort(np.concatenate([missing_r, missing_r + 1, missing_r + 2]))
        return Inpainting(channels, img_dim, missing, device=device)
    raise NotImplementedError(
        f"degradation {deg!r} is not ported to nshmc_tpu_torch yet "
        "(see ROADMAP.md, Queue 1: the other operators)")
