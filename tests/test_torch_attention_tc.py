"""K1 in bf16 runs on tensor cores (csrc/attention.cu), which sum the fp32
logits in 16-channel k-steps, in another order than the plain version's
matmul. These CPU tests pin what the card check of
`nshmc_tpu_torch.scripts.kernel_check` may accept for that, using the plain
version with its logits summed in 16-channel chunks as a stand-in for any
other fp32 summation order. Inputs from numpy with a seed."""
import math

import numpy as np
import pytest
import torch

from nshmc_tpu_torch.ops import attention as attn_mod
from nshmc_tpu_torch.scripts import kernel_check as kc

torch.set_num_threads(2)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal(shape[:3] + (3, shape[3])).astype(np.float32))
    return [qkv[..., i, :].bfloat16() for i in range(3)]


def _plain_chunked(q, k, v, round_weights=True):
    """attention_plain with the fp32 logits summed in 16-channel chunks; with
    round_weights=False the normalized weights are not cast to bf16."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    qs, ks = attn_mod._scale_in(q, scale).float(), attn_mod._scale_in(k, scale).float()
    logits = sum(torch.einsum("bthc,bshc->bhts", qs[..., i:i + 16], ks[..., i:i + 16])
                 for i in range(0, q.shape[-1], 16))
    w = torch.softmax(logits, dim=-1)
    w = w.to(v.dtype).float() if round_weights else w
    return torch.einsum("bhts,bshc->bthc", w, v.float()).to(q.dtype)


SHAPES = [(8, 64, 8, 64), (8, 256, 8, 64)]


def test_another_summation_order_passes_the_bf16_check():
    """A change of fp32 summation order moves a few weights to their other
    bf16 neighbour: a fraction of a percent of the outputs differ, some by
    more than one bf16 ulp + 2^-12, all within the check's bound."""
    beyond = 0
    for shape in SHAPES:
        for seed in range(4):
            q, k, v = _qkv(shape, seed)
            res = kc.bf16_attention_agreement(
                _plain_chunked(q, k, v), attn_mod.attention_plain(q, k, v),
                attn_mod.attention_weights_plain(q, k, v.dtype), v)
            assert res["ok"] and res["frac_differ"] < 0.005, res
            beyond += res["beyond_one_ulp"]
    assert beyond > 0  # one bf16 ulp + 2^-12 alone would refuse the reordering


@pytest.mark.parametrize("shape", SHAPES)
def test_unrounded_weights_fail_the_bf16_check(shape):
    """Dropping the weights' cast to bf16 before the PV product (the
    rounding `_attn_kernel` makes) changes ~41% of the outputs."""
    q, k, v = _qkv(shape, 0)
    res = kc.bf16_attention_agreement(
        _plain_chunked(q, k, v, round_weights=False), attn_mod.attention_plain(q, k, v),
        attn_mod.attention_weights_plain(q, k, v.dtype), v)
    assert not res["ok"] and res["frac_differ"] > 0.3, res
