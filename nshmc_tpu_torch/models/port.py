"""Weights for the ADM U-Net (port of nshmc_tpu/models/port.py).

The port's parameter names ARE the reference checkpoint's `state_dict`
keys, so a reference checkpoint (models/ffhq_10m.pt) loads with
`load_state_dict(strict=True)` and no conversion. This module keeps its own
copy of the JAX package's layer enumeration (`adm_param_mapping`: JAX layer
path -> reference key prefix) and uses it the other way round:
`state_dict_from_jax` turns the JAX package's params (numpy arrays) into a
port state_dict, the inverse of nshmc_tpu/models/port.py::_convert:

  conv    (kh, kw, I, O) -> (O, I, kh, kw)
  conv1d  (I, O)         -> (O, I, 1)      [attention qkv / proj_out]
  dense   (I, O)         -> (O, I)
  groupnorm scale/bias   -> weight/bias
  embed   (N, D)         -> (N, D)           [label_emb]

Where `context_dim` is set, each attention site is a SpatialTransformer: its
JAX subtree maps under the site's prefix through models/ldm/transformer.py::
spatial_transformer_state_dict_from_jax (the JAX package's own mapping
knows only AttentionBlock sites there).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .unet import UNetConfig, UNetModel


def _resblock_entries(jax_prefix: str, torch_prefix: str, has_skip: bool):
    out = {
        f"{jax_prefix}/in_norm": (f"{torch_prefix}.in_layers.0", "groupnorm"),
        f"{jax_prefix}/in_conv": (f"{torch_prefix}.in_layers.2", "conv"),
        f"{jax_prefix}/emb_proj": (f"{torch_prefix}.emb_layers.1", "dense"),
        f"{jax_prefix}/out_norm": (f"{torch_prefix}.out_layers.0", "groupnorm"),
        f"{jax_prefix}/out_conv": (f"{torch_prefix}.out_layers.3", "conv"),
    }
    if has_skip:
        out[f"{jax_prefix}/skip"] = (f"{torch_prefix}.skip_connection", "conv")
    return out


def _attn_entries(jax_prefix: str, torch_prefix: str, conditional: bool = False):
    if conditional:
        return {jax_prefix: (torch_prefix, "spatial_transformer")}
    return {
        f"{jax_prefix}/norm": (f"{torch_prefix}.norm", "groupnorm"),
        f"{jax_prefix}/qkv": (f"{torch_prefix}.qkv", "conv1d"),
        f"{jax_prefix}/proj_out": (f"{torch_prefix}.proj_out", "conv1d"),
    }


def adm_param_mapping(cfg: UNetConfig) -> Dict[str, Tuple[str, str]]:
    """JAX layer path -> (reference key prefix, kind)
    (nshmc_tpu/models/port.py:49-128)."""
    m: Dict[str, Tuple[str, str]] = {
        "time_embed_1": ("time_embed.0", "dense"),
        "time_embed_2": ("time_embed.2", "dense"),
        "in_conv": ("input_blocks.0.0", "conv"),
        "out_norm": ("out.0", "groupnorm"),
        "out_conv": ("out.2", "conv"),
    }
    if cfg.num_classes is not None:
        m["label_emb"] = ("label_emb", "embed")

    cond = cfg.context_dim is not None
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    input_chans = [ch]
    idx = 1
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = int(mult * mc)
        for i in range(cfg.num_res_blocks):
            m.update(_resblock_entries(f"down_{level}_{i}/res", f"input_blocks.{idx}.0",
                                       has_skip=(ch != out_ch)))
            ch = out_ch
            if ds in cfg.attention_ds:
                m.update(_attn_entries(f"down_{level}_{i}/attn", f"input_blocks.{idx}.1", cond))
            input_chans.append(ch)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                m.update(_resblock_entries(f"down_{level}_downres",
                                           f"input_blocks.{idx}.0", has_skip=False))
            else:
                m[f"down_{level}_downsample/conv"] = (f"input_blocks.{idx}.0.op", "conv")
            input_chans.append(ch)
            idx += 1
            ds *= 2

    m.update(_resblock_entries("middle/res1", "middle_block.0", has_skip=False))
    m.update(_attn_entries("middle/attn", "middle_block.1", cond))
    m.update(_resblock_entries("middle/res2", "middle_block.2", has_skip=False))

    idx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        out_ch = int(mult * mc)
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            m.update(_resblock_entries(f"up_{level}_{i}/res", f"output_blocks.{idx}.0",
                                       has_skip=(ch + ich != out_ch)))
            ch = out_ch
            j = 1
            if ds in cfg.attention_ds:
                m.update(_attn_entries(f"up_{level}_{i}/attn", f"output_blocks.{idx}.{j}",
                                       cond))
                j += 1
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    m.update(_resblock_entries(f"up_{level}_{i}/upres",
                                               f"output_blocks.{idx}.{j}", has_skip=False))
                else:
                    m[f"up_{level}_{i}/upsample/conv"] = (
                        f"output_blocks.{idx}.{j}.conv", "conv")
                ds //= 2
            idx += 1
    return m


def _from_jax(kind: str, leaves) -> Dict[str, np.ndarray]:
    if kind == "conv":
        return {"weight": np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1),
                "bias": np.asarray(leaves["bias"])}
    if kind == "conv1d":
        return {"weight": np.asarray(leaves["kernel"]).T[:, :, None],
                "bias": np.asarray(leaves["bias"])}
    if kind == "dense":
        return {"weight": np.asarray(leaves["kernel"]).T, "bias": np.asarray(leaves["bias"])}
    if kind == "groupnorm":
        return {"weight": np.asarray(leaves["scale"]), "bias": np.asarray(leaves["bias"])}
    if kind == "embed":
        return {"weight": np.asarray(leaves["embedding"])}
    if kind == "spatial_transformer":
        from .ldm.transformer import spatial_transformer_state_dict_from_jax

        return spatial_transformer_state_dict_from_jax(leaves)
    raise ValueError(f"layer kind {kind!r} is not ported")


def state_dict_from_jax(params, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX U-Net params ({"params": {...}} or the inner tree, leaves as numpy
    arrays) -> float32 port state_dict with the reference keys."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for path, (prefix, kind) in adm_param_mapping(cfg).items():
        node = tree
        for part in path.split("/"):
            node = node[part]
        for name, arr in _from_jax(kind, node).items():
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def load_adm_checkpoint(path: str, cfg: UNetConfig, dtype=torch.bfloat16,
                        device="cuda") -> UNetModel:
    """A reference checkpoint file -> a frozen UNetModel on `device`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = UNetModel(cfg, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
