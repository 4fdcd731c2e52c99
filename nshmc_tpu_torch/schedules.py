"""Diffusion noise schedules and DDIM timestep sequences.

Port of `nshmc_tpu/schedules.py`: the tables are computed host-side in
float64 NumPy (bit-equal to the JAX package's) and frozen into tensors on
the caller's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_betas(
    schedule: str,
    beta_start: float,
    beta_end: float,
    num_timesteps: int,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule table in float64 (nshmc_tpu/schedules.py:18-54)."""
    if schedule == "quad":
        betas = (
            np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps, dtype=np.float64)
            ** 2
        )
    elif schedule in ("linear", "sqrt_linear"):
        betas = np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)
    elif schedule == "const":
        betas = beta_end * np.ones(num_timesteps, dtype=np.float64)
    elif schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(num_timesteps, 1, num_timesteps, dtype=np.float64)
    elif schedule == "sigmoid":
        x = np.linspace(-6, 6, num_timesteps)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    elif schedule == "cosine":
        ts = np.arange(num_timesteps + 1, dtype=np.float64) / num_timesteps + cosine_s
        alphas = np.cos(ts / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - (alphas[1:] / alphas[:-1])
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt":
        betas = (
            np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64) ** 0.5
        )
    else:
        raise NotImplementedError(f"unknown beta schedule: {schedule}")
    if betas.shape != (num_timesteps,):
        raise ValueError(f"beta table shape {betas.shape} != ({num_timesteps},)")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Frozen schedule tables on one device.

    `alphas_cumprod_padded[t + 1]` is alpha-bar at timestep t, with a
    leading 1.0 so that t = -1 (the DDIM terminal step) maps to 1.
    """

    betas: torch.Tensor  # (T,)
    alphas_cumprod: torch.Tensor  # (T,)
    alphas_cumprod_padded: torch.Tensor  # (T + 1,), [1.0, a_0, ..., a_{T-1}]

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def alpha_bar(self, t: int) -> torch.Tensor:
        """alpha-bar at integer timestep t (t = -1 allowed), 0-dim tensor."""
        return self.alphas_cumprod_padded[t + 1]

    @classmethod
    def create(
        cls,
        schedule: str = "linear",
        beta_start: float = 1e-4,
        beta_end: float = 2e-2,
        num_timesteps: int = 1000,
        device="cuda",
    ) -> "DiffusionSchedule":
        betas = make_betas(schedule, beta_start, beta_end, num_timesteps)
        alphas_cumprod = np.cumprod(1.0 - betas)
        padded = np.concatenate([[1.0], alphas_cumprod])
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return cls(betas=as_t(betas), alphas_cumprod=as_t(alphas_cumprod),
                   alphas_cumprod_padded=as_t(padded))

    @classmethod
    def from_alphas_cumprod(cls, alphas_cumprod, device="cuda") -> "DiffusionSchedule":
        """From a model's registered alpha-bar table (an LDM checkpoint's
        `alphas_cumprod` buffer; nshmc_tpu/schedules.py:96-109)."""
        alphas_cumprod = np.asarray(alphas_cumprod, np.float64)
        prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        betas = 1.0 - alphas_cumprod / prev
        padded = np.concatenate([[1.0], alphas_cumprod])
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return cls(betas=as_t(betas), alphas_cumprod=as_t(alphas_cumprod),
                   alphas_cumprod_padded=as_t(padded))


@dataclasses.dataclass(frozen=True)
class DDIMSequence:
    """The few-step DDIM timestep ladder (nshmc_tpu/schedules.py:111-139).

    skip = T // (timesteps + 1); seq = [skip, 2*skip, ...];
    seq_next = [-1] + seq[:-1]. For T=1000, timesteps=3: seq=[250, 500, 750],
    seq_next=[-1, 250, 500]; sampling runs 750 -> 500 -> 250 -> x0.
    """

    seq: tuple  # ascending timesteps
    seq_next: tuple  # one-step-lower targets, aligned with seq

    @classmethod
    def create(cls, num_timesteps: int, steps: int) -> "DDIMSequence":
        skip = num_timesteps // (steps + 1)
        seq = list(range(skip, num_timesteps, skip))
        seq_next = [-1] + seq[:-1]
        return cls(seq=tuple(seq), seq_next=tuple(seq_next))

    def reversed_pairs(self) -> np.ndarray:
        """(n_steps, 2) int32 array of (t, t_next) in sampling order."""
        pairs = list(zip(reversed(self.seq), reversed(self.seq_next)))
        return np.asarray(pairs, np.int32)

    @property
    def n_steps(self) -> int:
        return len(self.seq)
