"""Dataset loading (the port's own copy of nshmc_tpu/utils/datasets.py,
which has no JAX in it; the port imports nothing of the JAX package).

The reference data layer (datasets/__init__.py:47-197,
datasets/npydataset.py:5, datasets/celeba.py) without a DataLoader: simple
deterministic iterators over image folders / npy stacks yielding float32
[0, 1] NHWC numpy arrays, with the reference's transforms
(resize-to-image_size for FFHQ/ImageFolder; CelebA center-crop cx=89 cy=121
then resize). numpy and PIL only.

LSUN's lmdb-backed dataset (datasets/lsun.py) reads through the
pure-python parser of utils/lmdb_reader.py.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .images import list_dataset, load_image


class FolderDataset:
    """ImageFolder-equivalent (ref: datasets/__init__.py:112-131)."""

    def __init__(self, root: str, image_size: int = 256,
                 celeba_crop: bool = False):
        self.files = list_dataset(root)
        self.image_size = image_size
        self.celeba_crop = celeba_crop
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        if not self.celeba_crop:
            return load_image(self.files[i], self.image_size)
        from PIL import Image

        img = Image.open(self.files[i]).convert("RGB")
        # CelebA center crop (ref: datasets/__init__.py CelebA transform:
        # cx=89, cy=121, 128x128 crop window)
        cx, cy = 89, 121
        x1, x2 = cy - 64, cy + 64
        y1, y2 = cx - 64, cx + 64
        img = img.crop((y1, x1, y2, x2)).resize(
            (self.image_size, self.image_size)
        )
        return np.asarray(img, np.float32) / 255.0


class NpyDataset:
    """Stack-of-images .npy dataset (ref: datasets/npydataset.py:5)."""

    def __init__(self, path: str, image_size: int = 256):
        arr = np.load(path)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.shape[-1] not in (1, 3):  # NCHW -> NHWC
            arr = arr.transpose(0, 2, 3, 1)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        self.arr = arr.astype(np.float32)
        self.image_size = image_size

    def __len__(self):
        return self.arr.shape[0]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.arr[i]


class LSUNDataset:
    """LSUN lmdb-backed class dataset (ref: datasets/lsun.py:11-61),
    read through the pure-python LMDB parser (utils/lmdb_reader.py) —
    no lmdb C dependency. Values are encoded images (webp in LSUN
    exports); decoded with PIL, center-cropped on the long edge, and
    resized."""

    def __init__(self, root: str, image_size: int = 256):
        from .lmdb_reader import LMDBReader

        self.reader = LMDBReader(root)
        self.image_size = image_size
        # the reference caches the key list next to the db (lsun.py:30-36)
        self.keys = self.reader.keys()

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i: int) -> np.ndarray:
        import io
        from PIL import Image

        buf = self.reader.get(self.keys[i])
        img = Image.open(io.BytesIO(buf)).convert("RGB")
        img = _center_crop_long_edge(img).resize(
            (self.image_size, self.image_size))
        return np.asarray(img, np.float32) / 255.0


def _center_crop_long_edge(img):
    """CenterCropLongEdge (ref: datasets/imagenet_subset.py:20-33)."""
    w, h = img.size
    s = min(w, h)
    left = (w - s) // 2
    top = (h - s) // 2
    return img.crop((left, top, left + s, top + s))


class ImageNetSubset:
    """Meta-file-listed ImageNet subset with CenterCropLongEdge + resize
    (ref: datasets/imagenet_subset.py:48-100, the val_100 list path at
    datasets/__init__.py:160-166)."""

    def __init__(self, root: str, meta_file: str, image_size: int = 256):
        with open(meta_file) as f:
            self.files = [
                os.path.join(root, line.split()[0])
                for line in f if line.strip()
            ]
        self.image_size = image_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.files[i]).convert("RGB")
        img = _center_crop_long_edge(img).resize(
            (self.image_size, self.image_size))
        return np.asarray(img, np.float32) / 255.0


def get_dataset(name: str, root: str, image_size: int = 256,
                meta_file: Optional[str] = None):
    """Dataset dispatch (ref: datasets/__init__.py:47-197)."""
    name = name.lower()
    if name in ("ffhq", "imagefolder"):
        return FolderDataset(root, image_size)
    if name == "imagenet":
        if meta_file:
            return ImageNetSubset(root, meta_file, image_size)
        return FolderDataset(root, image_size)
    if name in ("celeba", "celeba_hq"):
        return FolderDataset(root, image_size,
                             celeba_crop=(name == "celeba"))
    if name == "npy" or root.endswith(".npy"):
        return NpyDataset(root, image_size)
    if name == "lsun":
        return LSUNDataset(root, image_size)
    raise ValueError(f"unknown dataset {name!r}")


def iterate(dataset, start: int = 0, end: Optional[int] = None,
            shuffle_seed: Optional[int] = None) -> Iterator[Tuple[int, np.ndarray]]:
    """Deterministic (optionally seeded-shuffled) iteration, mirroring the
    reference's seeded DataLoader + Subset behavior
    (ref: main_sampling.py:371-403)."""
    idx = np.arange(len(dataset))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(idx)
    end = len(dataset) if end is None else min(end, len(dataset))
    for i in idx[start:end]:
        yield int(i), dataset[int(i)]


def prefetch(iterator, depth: int = 2):
    """Background-thread prefetch so host image decode overlaps device
    compute, in place of the reference's multi-worker DataLoader
    (main_sampling.py:396-403)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
