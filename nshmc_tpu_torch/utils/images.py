"""Image IO and value-range transforms (port of nshmc_tpu/utils/images.py).

PIL for IO, torch or numpy for math. `save_std_dev_map` writes the
normalised pixel-wise std-dev map through a "hot" colour map with PIL
alone: the JAX package draws it with matplotlib (adding a colour bar and a
title), which the GPU host does not have.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch


def data_transform(x01):
    """[0, 1] -> [-1, 1]."""
    return 2.0 * x01 - 1.0


def inverse_data_transform(x):
    """[-1, 1] -> [0, 1], clipped."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def load_image(path: str, size: int = 256) -> np.ndarray:
    """PNG/JPG -> float32 [0, 1] (H, W, 3), bicubic-resized to size."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BICUBIC)
    return np.asarray(img, np.float32) / 255.0


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_image(x01, path: str):
    """float [0, 1] (H, W, 3) -> 8-bit PNG."""
    from PIL import Image

    arr = (np.clip(_to_numpy(x01), 0, 1) * 255.0).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)


def save_std_dev_map(samples01, path: str):
    """Pixel-wise std-dev map across a sample stack (S, H, W, C), min-max
    normalised and coloured with the "hot" map (black-red-yellow-white)."""
    std = _to_numpy(samples01).std(axis=0).mean(axis=-1)
    span = std.max() - std.min()
    v = (std - std.min()) / (span if span > 0 else 1.0)
    rgb = np.stack([np.clip(3 * v, 0, 1), np.clip(3 * v - 1, 0, 1),
                    np.clip(3 * v - 2, 0, 1)], axis=-1)
    save_image(rgb, path)


def list_dataset(root: str, exts=(".png", ".jpg", ".jpeg")) -> List[str]:
    """Sorted recursive listing of image files."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(exts):
                out.append(os.path.join(dirpath, f))
    return sorted(out)
