"""Spectral-space posterior samplers: DDNM and DDRM (port of
nshmc_tpu/algos/spectral.py).

  DDNM - null-space projection with a lambda_t-blended range-space
         correction for noisy measurements;
  DDRM - the variational spectral update with three regimes split on
         singulars * sigma_next against sigma_0.

Every operation is elementwise in the operator's V basis: the masks are
`torch.where` over full-dimension vectors (rank coefficients first, then the
null space), safe at zero singular values.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..operators.base import pad_zeros, unflatten_image
from .base import Algo, predict_eps, predict_x0, randn


def _padded_sigma(op, d):
    """(Sigma, Inv_Sigma) padded to the full V-space dimension `d`."""
    s = op.singulars()
    sigma = pad_zeros(s[None], d)[0]
    nonzero = sigma != 0
    inv = torch.where(nonzero, 1.0 / torch.where(nonzero, sigma, torch.ones_like(sigma)),
                      torch.zeros_like(sigma))
    return sigma, inv


def _pad_rank(vec_rank, d):
    """Zero-pad a (B, rank) spectral vector to (B, d)."""
    return pad_zeros(vec_rank, d)


def _image_dim(x):
    return x.shape[1] * x.shape[2] * x.shape[3]


@dataclasses.dataclass(frozen=True)
class DDNM(Algo):
    """Denoising diffusion null-space model."""

    eta: float = 0.85

    def draw(self, generator, xt):
        """x0's shape when noiseless, else (B, d) in the V basis."""
        shape = xt.shape if self.sigma_0 == 0 else (xt.shape[0], _image_dim(xt))
        return (randn(shape, generator, xt),)

    def _lambda_t(self, sigma, inv_sigma, at_next):
        sigma_t = torch.sqrt(1 - at_next)
        thresh = torch.sqrt(at_next) * self.sigma_0 * inv_sigma
        lam = torch.where(sigma_t < thresh,
                          sigma * sigma_t * math.sqrt(1 - self.eta**2)
                          / torch.sqrt(at_next) / self.sigma_0,
                          torch.ones_like(sigma))
        return lam, sigma_t, thresh

    def _range_correction(self, x0, y0, at_next):
        op = self.operator
        sigma, inv_sigma = _padded_sigma(op, _image_dim(x0))
        lam, sigma_t, thresh = self._lambda_t(sigma, inv_sigma, at_next)
        correction = op.Vt(op.H_pinv(op.H_img(x0) - y0))
        x0 = x0 - self._img(op.V(lam[None] * correction), x0)
        return x0, sigma, inv_sigma, sigma_t, thresh

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        op = self.operator
        et = predict_eps(model_fn, xt, t)
        x0 = predict_x0(xt, et, at)
        (noise,) = draws
        if self.sigma_0 == 0:
            # noiseless: the plain pseudo-inverse data consistency
            x0 = x0 + self._img(op.H_pinv(y0 - op.H_img(x0)), x0)
            add_up = (self.eta * torch.sqrt(1 - at_next) * noise
                      + math.sqrt(1 - self.eta**2) * torch.sqrt(1 - at_next) * et)
            return x0, add_up, state

        v_t_et = op.Vt(self._flat(et))
        x0, sigma, inv_sigma, sigma_t, thresh = self._range_correction(x0, y0, at_next)
        eps_tmp = torch.where(sigma_t >= thresh,
                              (sigma_t**2 - at_next * self.sigma_0**2 * inv_sigma**2) * noise,
                              self.eta * sigma_t * noise)
        eps_tmp = torch.where(sigma == 0,
                              sigma_t * math.sqrt(1 - self.eta**2) * v_t_et
                              + sigma_t * self.eta * noise,
                              eps_tmp)
        return x0, self._img(op.V(eps_tmp), x0), state

    def get_pred_x(self, gt, y0, at_next):
        """Range-space refinement of a given x0."""
        if self.sigma_0 == 0:
            return gt
        return self._range_correction(gt, y0, at_next)[0]


def ddrm_init_x(noise, op, y0, sigma_0, alpha_bar_T, shape):
    """DDRM's x_T ~ p(x_T | y) (nshmc_tpu/algos/spectral.py:99-130): spectral
    directions observed above the noise floor start from Sig^-1 U^T y, the
    rest from scaled Gaussian noise. `noise` is the (B, d) standard-normal
    draw; shape (B, H, W, C); returns an NHWC x_T batch."""
    b, d = shape[0], shape[1] * shape[2] * shape[3]
    sigma_pad, _ = _padded_sigma(op, d)
    largest_sigma = torch.sqrt(1 - alpha_bar_T) / torch.sqrt(alpha_bar_T)
    u_t_y = op.Ut(y0)  # (B, rank)
    large = sigma_pad * largest_sigma > sigma_0
    s_safe = torch.where(sigma_pad != 0, sigma_pad, torch.ones_like(sigma_pad))
    inv_sing_zero = torch.where(large, sigma_0 / s_safe, torch.zeros_like(s_safe))
    r = u_t_y.shape[1]
    init_y = _pad_rank(torch.where(large[None, :r], u_t_y / s_safe[None, :r],
                                   torch.zeros_like(u_t_y)), d)
    remaining = torch.sqrt(torch.clamp(largest_sigma**2 - inv_sing_zero**2, min=0.0))
    init_y = (init_y + remaining[None] * noise) / largest_sigma
    return unflatten_image(op.V(init_y), shape[3], shape[1])


@dataclasses.dataclass(frozen=True)
class DDRM(Algo):
    """Denoising diffusion restoration model."""

    etaB: float = 1.0
    etaA: float = 0.85
    etaC: float = 0.85

    def draw(self, generator, xt):
        """(B, d), (B, d) and (B, rank): JAX's split(sub, 3) in that order."""
        b, d = xt.shape[0], _image_dim(xt)
        rank = self.operator.singulars().shape[0]
        return (randn((b, d), generator, xt), randn((b, d), generator, xt),
                randn((b, rank), generator, xt))

    def _spectral_update(self, x0, et, y0, at_next, draws=None):
        op = self.operator
        d = _image_dim(x0)
        s = op.singulars()
        rank = s.shape[0]
        s_safe = torch.where(s != 0, s, torch.ones_like(s))

        u_t_y = op.Ut(y0)  # (B, rank)
        sig_inv_u_t_y = u_t_y / s_safe[None, : u_t_y.shape[1]]
        sigma_next = torch.sqrt(1 - at_next) / torch.sqrt(at_next)
        v_t_x0 = op.Vt(self._flat(x0))  # (B, d)
        s_v_t_x0 = v_t_x0[:, :rank] * s[None]

        cond_before = _pad_rank((s * sigma_next > self.sigma_0)[None].float(), d)[0] > 0
        cond_after = _pad_rank((s * sigma_next < self.sigma_0)[None].float(), d)[0] > 0
        zero = torch.zeros((), dtype=torch.float32, device=x0.device)
        std_next_c = sigma_next * self.etaC
        sigma_tilde_next_c = torch.sqrt(torch.maximum(sigma_next**2 - std_next_c**2, zero))
        std_next_a = sigma_next * self.etaA
        sigma_tilde_next_a = torch.sqrt(torch.maximum(sigma_next**2 - std_next_a**2, zero))
        diff_sigma_b = torch.sqrt(torch.maximum(
            sigma_next**2 - self.sigma_0**2 / s_safe**2 * self.etaB**2, zero))

        # base case: the null-space coefficients keep V^T x0; after: less
        # noisy than y; before: noisier than y
        after_corr = _pad_rank((u_t_y - s_v_t_x0) / self.sigma_0, d)
        vt_mod = torch.where(cond_after[None], v_t_x0 + sigma_tilde_next_a * after_corr, v_t_x0)
        before_val = _pad_rank(sig_inv_u_t_y * self.etaB, d) + (1 - self.etaB) * v_t_x0
        vt_mod = torch.where(cond_before[None], before_val, vt_mod)
        x0_new = self._img(op.V(vt_mod), x0)
        if draws is None:
            return x0_new, None

        n_full, n_after, n_before = draws
        vt_add = sigma_tilde_next_c * op.Vt(self._flat(et)) + std_next_c * n_full
        vt_add = torch.where(cond_after[None], std_next_a * n_after, vt_add)
        vt_add = torch.where(cond_before[None], _pad_rank(diff_sigma_b[None] * n_before, d),
                             vt_add)
        return x0_new, self._img(op.V(vt_add), x0) * torch.sqrt(at_next)

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        et = predict_eps(model_fn, xt, t)
        x0 = predict_x0(xt, et, at)
        x0_new, add_up = self._spectral_update(x0, et, y0, at_next, draws)
        return x0_new, add_up, state

    def get_pred_x(self, gt, y0, at_next):
        """Noise-free variational refinement."""
        if self.sigma_0 == 0:
            return gt
        return self._spectral_update(gt, None, y0, at_next)[0]
