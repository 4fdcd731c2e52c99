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


# the bf16 kernel's design at each sequence length of kernel_check's K1
# shapes: the flagship's 256 and 64, the latent U-Net's 256 and 64 and Stable
# Diffusion's 256 and 64 stay resident; Stable Diffusion's 4096 and 1024, the
# latent U-Net's 1024 and the edge shapes' 1000 stream through the long one
DESIGN_BY_T = {1: "resident", 16: "resident", 64: "resident", 100: "resident",
               256: "resident", 1000: "long", 1024: "long", 4096: "long"}


@pytest.mark.parametrize("shape", kc.ATTN_SHAPES, ids=str)
def test_bf16_design_by_shape(shape):
    assert attn_mod.bf16_design(shape[1]) == DESIGN_BY_T[shape[1]]


def _tiled(q, k, v, one_pass, bk=128):
    """One (b, h) of K1 in bf16 over key tiles of `bk`, fp32 logits summed
    as the plain version sums them. Two passes: an online row max and
    denominator, then exp(s - m) / l cast to bf16 before the product with V
    (the kernel's schedule). One pass: the online softmax of flash attention,
    which casts exp(s - m_running) to bf16 before its product with V and
    divides by l at the end."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    qs, ks = attn_mod._scale_in(q, scale).float()[0, :, 0], attn_mod._scale_in(k, scale).float()[0, :, 0]
    vf = v.float()[0, :, 0]
    t = qs.shape[0]
    m = torch.full((t, 1), -math.inf)
    l, acc = torch.zeros(t, 1), torch.zeros(t, vf.shape[1])
    for k0 in range(0, t, bk):
        s = qs @ ks[k0:k0 + bk].T
        mn = torch.maximum(m, s.max(-1, keepdim=True).values)
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        if one_pass:
            acc = acc * alpha + p.to(v.dtype).float() @ vf[k0:k0 + bk]
        m = mn
    if one_pass:
        return (acc / l).to(q.dtype)[None, :, None]
    for k0 in range(0, t, bk):
        w = (torch.exp(qs @ ks[k0:k0 + bk].T - m) / l).to(v.dtype).float()
        acc = acc + w @ vf[k0:k0 + bk]
    return acc.to(q.dtype)[None, :, None]


@pytest.mark.parametrize("one_pass", [False, True], ids=["two_pass", "one_pass"])
def test_tiled_schedule_at_4096_tokens(one_pass):
    """At Stable Diffusion's 4096 tokens, the long design's schedule (two
    passes over 128-key tiles, the normalized weights cast to bf16) passes
    the bf16 check; a one-pass online softmax, which casts weights before
    they are normalized, fails it: a one-pass bf16 kernel cannot keep K1's
    rounding."""
    q, k, v = _qkv((1, 4096, 1, 64), 0)
    res = kc.bf16_attention_agreement(
        _tiled(q, k, v, one_pass), attn_mod.attention_plain(q, k, v),
        attn_mod.attention_weights_plain(q, k, v.dtype), v)
    if one_pass:
        assert not res["ok"] and res["frac_differ"] > 0.3, res
    else:
        assert res["ok"] and res["frac_differ"] < 0.02, res
