"""Weights for the latent path (port of nshmc_tpu/models/ldm/port.py).

The port's parameter names ARE the reference checkpoint's keys, so a
reference LDM checkpoint loads without conversion: `split_ldm_checkpoint`
cuts a Lightning LatentDiffusion `state_dict` into the latent U-Net's keys
(`model.diffusion_model.*`), the first stage's (`first_stage_model.*`) and
the registered `alphas_cumprod`, and `LatentDiffusion.load_checkpoint`
loads each with `load_state_dict(strict=True)`.

This module keeps its own copy of the JAX package's layer enumeration
(`ae_param_mapping`: JAX layer path -> reference key prefix) and uses it the
other way round: `ae_state_dict_from_jax` turns the JAX package's VQModel
params (numpy arrays) into a port state_dict, the inverse of
nshmc_tpu/models/port.py::_convert (conv (kh, kw, I, O) -> (O, I, kh, kw),
GroupNorm scale -> weight, the codebook -> quantize.embedding.weight). The
latent U-Net goes through the U-Net's own bridge,
models/port.py::state_dict_from_jax.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..port import _from_jax
from .autoencoder import AutoencoderConfig

UNET_PREFIX = "model.diffusion_model."
AE_PREFIX = "first_stage_model."


def _ae_block_entries(jax_prefix: str, torch_prefix: str, has_shortcut: bool):
    out = {
        f"{jax_prefix}/norm1": (f"{torch_prefix}.norm1", "groupnorm"),
        f"{jax_prefix}/conv1": (f"{torch_prefix}.conv1", "conv"),
        f"{jax_prefix}/norm2": (f"{torch_prefix}.norm2", "groupnorm"),
        f"{jax_prefix}/conv2": (f"{torch_prefix}.conv2", "conv"),
    }
    if has_shortcut:
        out[f"{jax_prefix}/nin_shortcut"] = (f"{torch_prefix}.nin_shortcut", "conv")
    return out


def _ae_attn_entries(jax_prefix: str, torch_prefix: str):
    return {f"{jax_prefix}/{n}": (f"{torch_prefix}.{n}", "groupnorm" if n == "norm" else "conv")
            for n in ("norm", "q", "k", "v", "proj_out")}


def ae_param_mapping(cfg: AutoencoderConfig) -> Dict[str, Tuple[str, str]]:
    """JAX layer path -> (reference key prefix, kind) of a VQModel, or of an
    AutoencoderKL where cfg.double_z (nshmc_tpu/models/ldm/port.py:41-104)."""
    m: Dict[str, Tuple[str, str]] = {"encoder/conv_in": ("encoder.conv_in", "conv")}
    block_in, curr_res = cfg.ch, cfg.resolution
    for i, mult in enumerate(cfg.ch_mult):
        for j in range(cfg.num_res_blocks):
            m.update(_ae_block_entries(f"encoder/down_{i}_block_{j}",
                                       f"encoder.down.{i}.block.{j}",
                                       has_shortcut=block_in != cfg.ch * mult))
            block_in = cfg.ch * mult
            if curr_res in cfg.attn_resolutions:
                m.update(_ae_attn_entries(f"encoder/down_{i}_attn_{j}",
                                          f"encoder.down.{i}.attn.{j}"))
        if i != len(cfg.ch_mult) - 1:
            m[f"encoder/down_{i}_downsample/conv"] = (f"encoder.down.{i}.downsample.conv", "conv")
            curr_res //= 2
    for part in ("encoder", "decoder"):
        m.update(_ae_block_entries(f"{part}/mid_block_1", f"{part}.mid.block_1", False))
        m.update(_ae_attn_entries(f"{part}/mid_attn_1", f"{part}.mid.attn_1"))
        m.update(_ae_block_entries(f"{part}/mid_block_2", f"{part}.mid.block_2", False))
        m[f"{part}/norm_out"] = (f"{part}.norm_out", "groupnorm")
        m[f"{part}/conv_out"] = (f"{part}.conv_out", "conv")

    m["decoder/conv_in"] = ("decoder.conv_in", "conv")
    block_in = cfg.ch * cfg.ch_mult[-1]
    curr_res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
    for i in reversed(range(len(cfg.ch_mult))):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            m.update(_ae_block_entries(f"decoder/up_{i}_block_{j}", f"decoder.up.{i}.block.{j}",
                                       has_shortcut=block_in != block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                m.update(_ae_attn_entries(f"decoder/up_{i}_attn_{j}", f"decoder.up.{i}.attn.{j}"))
        if i != 0:
            m[f"decoder/up_{i}_upsample/conv"] = (f"decoder.up.{i}.upsample.conv", "conv")
            curr_res *= 2
    m["quant_conv"] = ("quant_conv", "conv")
    m["post_quant_conv"] = ("post_quant_conv", "conv")
    if not cfg.double_z:  # a VQModel's codebook; an AutoencoderKL has none
        m["quantize"] = ("quantize.embedding", "embed")
    return m


def ae_state_dict_from_jax(params, cfg: AutoencoderConfig) -> Dict[str, torch.Tensor]:
    """JAX VQModel (or AutoencoderKL) params ({"params": {...}} or the inner
    tree, leaves as numpy arrays) -> float32 port state_dict with the
    reference keys."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for path, (prefix, kind) in ae_param_mapping(cfg).items():
        node = tree
        for part in path.split("/"):
            node = node[part]
        for name, arr in _from_jax(kind, node).items():
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def split_ldm_checkpoint(sd) -> Tuple[dict, dict, np.ndarray | None]:
    """A Lightning LatentDiffusion state_dict -> (latent U-Net state_dict,
    first-stage state_dict without its training-only `loss.*` keys,
    alphas_cumprod or None) (nshmc_tpu/models/ldm/port.py:128-154)."""
    unet_sd = {k[len(UNET_PREFIX):]: v for k, v in sd.items() if k.startswith(UNET_PREFIX)}
    ae_sd = {k[len(AE_PREFIX):]: v for k, v in sd.items()
             if k.startswith(AE_PREFIX) and not k.startswith(AE_PREFIX + "loss.")}
    ac = sd.get("alphas_cumprod")
    if ac is not None:
        ac = np.asarray(ac.detach().cpu().numpy() if hasattr(ac, "cpu") else ac, np.float64)
    return unet_sd, ae_sd, ac
