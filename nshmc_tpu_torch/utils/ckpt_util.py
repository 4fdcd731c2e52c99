"""Named checkpoints: the URL/MD5 registry and the local cache lookup (the
port's own copy of nshmc_tpu/utils/ckpt_util.py, from the reference's
functions/ckpt_util.py:5-72).

`get_ckpt_path` resolves a name to its file under `root` and verifies its
MD5 on request. The port never downloads: where the file is absent (or
fails the MD5 check), `download` raises and says where to place it.
"""
from __future__ import annotations

import hashlib
import os

URL_MAP = {
    "cifar10": "https://heibox.uni-heidelberg.de/f/869980b53bf5416c8b28/?dl=1",
    "ema_cifar10": "https://heibox.uni-heidelberg.de/f/2e4f01e2d9ee49bab1d5/?dl=1",
    "lsun_bedroom": "https://heibox.uni-heidelberg.de/f/f179d4f21ebc4d43bbfe/?dl=1",
    "ema_lsun_bedroom": "https://heibox.uni-heidelberg.de/f/b95206528f384185889b/?dl=1",
    "lsun_cat": "https://heibox.uni-heidelberg.de/f/fac870bd988348eab88e/?dl=1",
    "ema_lsun_cat": "https://heibox.uni-heidelberg.de/f/0701aac3aa69457bbe34/?dl=1",
    "lsun_church": "https://heibox.uni-heidelberg.de/f/2711a6f712e34b06b9d8/?dl=1",
    "ema_lsun_church": "https://heibox.uni-heidelberg.de/f/44ccb50ef3c6436db52e/?dl=1",
    "celeba_hq": "https://image-editing-test-12345.s3-us-west-2.amazonaws.com/checkpoints/celeba_hq.ckpt",
}
CKPT_MAP = {
    "cifar10": "diffusion_cifar10_model/model-790000.ckpt",
    "ema_cifar10": "ema_diffusion_cifar10_model/model-790000.ckpt",
    "lsun_bedroom": "diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "ema_lsun_bedroom": "ema_diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "lsun_cat": "diffusion_lsun_cat_model/model-1761000.ckpt",
    "ema_lsun_cat": "ema_diffusion_lsun_cat_model/model-1761000.ckpt",
    "lsun_church": "diffusion_lsun_church_model/model-4432000.ckpt",
    "ema_lsun_church": "ema_diffusion_lsun_church_model/model-4432000.ckpt",
}
MD5_MAP = {
    "cifar10": "82ed3067fd1002f5cf4c339fb80c4669",
    "ema_cifar10": "1fa350b952534ae442b1d5235cce5cd3",
    "lsun_bedroom": "f70280ac0e08b8e696f42cb8e948ff1c",
    "ema_lsun_bedroom": "1921fa46b66a3665e450e42f36c2720f",
    "lsun_cat": "bbee0e7c3d7abfb6e2539eaf2fb9987b",
    "ema_lsun_cat": "646f23f4821f2459b8bafc57fd824558",
    "lsun_church": "eb619b8a5ab95ef80f94ce8a5488dae3",
    "ema_lsun_church": "fdc68a23938c2397caba4a260bc2445f",
}


def md5_hash(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def download(url: str, local_path: str):
    """Raises: the port fetches nothing over the network, so a checkpoint
    must be placed at `local_path` by hand."""
    raise RuntimeError(f"cannot download {url} (no network egress: this package never "
                       f"fetches); place the checkpoint at {local_path} manually")


def get_ckpt_path(name: str, root: str = "exp/logs/diffusion_models_converted",
                  check: bool = False) -> str:
    """The named checkpoint's path under `root`, its MD5 verified when
    `check`; raises KeyError for an unknown name and RuntimeError (from
    `download`) where the file is absent or fails the check."""
    if name not in URL_MAP:
        raise KeyError(f"unknown checkpoint name {name!r}; known: {sorted(URL_MAP)}")
    path = os.path.join(root, CKPT_MAP.get(name, f"{name}.ckpt"))
    if not os.path.exists(path) or (
        check and name in MD5_MAP and md5_hash(path) != MD5_MAP[name]
    ):
        download(URL_MAP[name], path)
    return path
