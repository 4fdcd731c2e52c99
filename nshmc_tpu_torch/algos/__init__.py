"""The baseline algorithms and their registry (port of
nshmc_tpu/algos/__init__.py), with the reference's per-task hyperparameter
tables as data."""
from __future__ import annotations

from .base import Algo, Unconditional, predict_eps, predict_x0
from .guided import DMPS, DPS, PiGDM, REDdiff
from .optim_based import DAPS, DiffPIR, run_daps
from .spectral import DDNM, DDRM, ddrm_init_x

__all__ = [
    "Algo", "Unconditional", "DPS", "PiGDM", "DMPS", "REDdiff",
    "DDNM", "DDRM", "DiffPIR", "DAPS", "run_daps", "build_algo", "ddrm_init_x",
    "predict_eps", "predict_x0",
]

# per-task guidance weights; keys are substrings of the degradation, the
# first match wins, else the default
_DPS_LAM = {"phase": 0.4}
_REDDIFF_ETA_FFHQ = {
    "cs": 0.5, "deblur_nonlinear": 0.2, "deblur_aniso": 0.7,
    "inpainting": 0.4, "sr4": 7.0,
}
_REDDIFF_ETA_CELEBA = {
    "inp_box": 0.4, "inp": 0.5, "cs": 0.5, "deblur_nonlinear": 0.2,
    "hdr": 0.1, "sr_bicubic": 3.0, "sr4": 7.0, "deblur_aniso": 0.5,
}


def _table_lookup(table, deg, default):
    for k, v in table.items():
        if k in deg:
            return v
    return default


def build_algo(name: str, operator, sigma_0: float, deg: str = "", dataset: str = "ffhq",
               noise: str = "ddpm") -> Algo:
    """An algorithm by its CLI name (nshmc_tpu/algos/__init__.py:43-66)."""
    if name in ("hmc", "dmplug_adam", "dmplug_lbfgs", "unconditional"):
        return Unconditional(operator=operator, sigma_0=sigma_0, noise=noise)
    if name == "dps":
        return DPS(operator=operator, sigma_0=sigma_0, noise=noise,
                   lam=_table_lookup(_DPS_LAM, deg, 1.0))
    if name == "pigdm":
        return PiGDM(operator=operator, sigma_0=sigma_0, noise=noise, lam=1.0)
    if name == "dmps":
        return DMPS(operator=operator, sigma_0=sigma_0, noise=noise)
    if name == "reddiff":
        table = _REDDIFF_ETA_CELEBA if "celeba" in dataset else _REDDIFF_ETA_FFHQ
        return REDdiff(operator=operator, sigma_0=sigma_0, noise=noise,
                       eta=_table_lookup(table, deg, 1.0))
    if name == "ddnm":
        return DDNM(operator=operator, sigma_0=sigma_0, noise=noise)
    if name == "ddrm":
        return DDRM(operator=operator, sigma_0=sigma_0, noise=noise)
    if name == "diffpir":
        return DiffPIR(operator=operator, sigma_0=sigma_0, noise=noise, lam=7.0)
    if name == "daps":
        return DAPS(operator=operator, sigma_0=sigma_0, noise=noise,
                    nonlinear=not operator.is_linear())
    raise NotImplementedError(name)
