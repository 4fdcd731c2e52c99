"""K1 in f32 runs on tensor cores in 3xTF32, in one pass with an online
softmax (csrc/attention.cu, `attn_fwd_f32_kernel`). This host has no card,
so these CPU tests hold numerical models of the kernel's arithmetic against
the plain version (`attention_plain`, at the card check's f32 bar of 1e-4
absolute) and against the JAX package's `attention_xla` in f32 (atol 2e-4,
rtol 1e-3, the bar of tests/test_unet.py):
  - `tf32_rounding`: `cvt.rna.tf32.f32` as integer arithmetic on the fp32
    bits (the kernel rounds so), and the hi/lo split it gives, the lo part
    truncated to TF32;
  - `3xtf32`: products as a_lo b_hi + a_hi b_lo + a_hi b_hi of TF32 values
    stay within 1e-4, where one TF32 product (a_hi b_hi) breaks it: the
    reason for the split;
  - `online_softmax`: one pass over 64-key tiles with a running row max and
    denominator, within 1e-4 of the two-pass plain version;
  - `fragments`: an index-level model of the m16n8k8 tf32 C, A and B
    fragments of each lane: the permuted-key P.V (k-slot t carries key 2t,
    slot t + 4 key 2t + 1, so a0..a3 = c0, c2, c1, c3, and V's B fragment
    comes from keys 2t, 2t + 1) equals the plain product exactly, where the
    fragments taken as they lie do not; and the K and V reads of rows padded
    to ch + 4 floats fall in 32 distinct banks.
Inputs from numpy with a seed."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.ops.attention import attention_xla
from nshmc_tpu_torch.ops import attention as attn_mod

torch.set_num_threads(2)

SHAPES = [(2, 64, 2, 32), (2, 100, 3, 16), (1, 256, 2, 64)]
MODELS = ["tf32_rounding", "3xtf32", "online_softmax", "fragments"]
TILE = 64                 # keys per tile (F32_BK)
LOG2E = 1.4426950408889634


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal(shape[:3] + (3, shape[3])).astype(np.float32)
    return [np.ascontiguousarray(qkv[..., i, :]) for i in range(3)]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round fp32 to 10 mantissa bits, ties away from 0
    (add half of the dropped range to the magnitude bits, then cut them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo: hi rounded to TF32, lo = x - hi (exact) truncated to TF32."""
    hi = tf32_rna(x)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_product(eq, a, b, passes):
    """einsum(eq, a, b) as the kernel's tensor cores take it: 3 passes
    (3xTF32), 1 (plain TF32) or 0 (fp32 operands, no TF32 at all)."""
    if passes == 0:
        return torch.einsum(eq, a, b)
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def kernel_model(q, k, v, passes=3, tile=TILE, rescale=True):
    """The f32 kernel's arithmetic: q and k scaled in fp32, key tiles of
    `tile`, a running row max m and denominator l, exp as 2^(s log2 e - m
    log2 e), the accumulator rescaled by exp(m_old - m_new) (not at all
    with rescale=False), one division at the end; products by
    `tf32_product`."""
    b, t, h, ch = q.shape
    scale = torch.tensor(1.0 / math.sqrt(math.sqrt(ch)), dtype=torch.float32)
    qs, ks = q * scale, k * scale
    m = torch.full((b, h, t), -math.inf)
    l, acc = torch.zeros(b, h, t), torch.zeros(b, h, t, ch)
    l2e = torch.tensor(LOG2E, dtype=torch.float32)
    for k0 in range(0, t, tile):
        s = tf32_product("bthc,bshc->bhts", qs, ks[:, k0:k0 + tile], passes)
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.where(m == -math.inf, torch.zeros(()), torch.exp2(m * l2e - mn * l2e))
        alpha = alpha if rescale else torch.where(m == -math.inf, 0.0, 1.0)
        p = torch.exp2(s * l2e - (mn * l2e)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + tf32_product("bhts,bshc->bhtc", p, v[:, k0:k0 + tile],
                                                      passes)
        m = mn
    return (acc / l[..., None]).permute(0, 2, 1, 3)


def _references(shape):
    q, k, v = _qkv(shape)
    plain = attn_mod.attention_plain(*map(torch.from_numpy, (q, k, v)))
    xla = np.asarray(attention_xla(*map(jnp.asarray, (q, k, v))))
    return [torch.from_numpy(a) for a in (q, k, v)], plain, xla


def _held(y, plain, xla):
    """Within the card's f32 check of the plain version and the JAX bar."""
    err = float((y - plain).abs().max())
    assert err <= 1e-4, err
    np.testing.assert_allclose(y.numpy(), xla, atol=2e-4, rtol=1e-3)
    return err


# ---- m16n8k8 tf32 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32) ----

def c_frag(lane):
    """(row, col) of c0..c3 (16 x 8 accumulator)."""
    g, t = divmod(lane, 4)
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def a_frag(lane):
    """(row, k-slot) of a0..a3 (16 x 8, row-major A)."""
    g, t = divmod(lane, 4)
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def b_frag(lane):
    """(k-slot, col) of b0, b1 (8 x 8, column-major B)."""
    g, t = divmod(lane, 4)
    return [(t, g), (t + 4, g)]


def mma_model(a_regs, b_regs):
    """D = A . B of one m16n8k8 from the 32 lanes' registers; every element
    of A and B must be held by exactly one lane's register."""
    a, b = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
    for lane in range(32):
        for (r, c), val in zip(a_frag(lane), a_regs[lane]):
            assert np.isnan(a[r, c])
            a[r, c] = val
        for (r, c), val in zip(b_frag(lane), b_regs[lane]):
            assert np.isnan(b[r, c])
            b[r, c] = val
    assert not (np.isnan(a).any() or np.isnan(b).any())
    return a @ b


def fragment_products(shape):
    """One 64-key tile at the shape's head width, integer-valued so every sum
    is exact: S = Q.K^T from the A (Q) and B (K: key g, channels t, t + 4)
    fragments, then O = P.V with P taken from S's C fragments, permuted or
    as they lie. Returns (S, Q K^T, O permuted, O unpermuted, P V)."""
    ch = shape[3]
    rng = np.random.default_rng(sum(shape))
    qm = rng.integers(-4, 5, (16, ch)).astype(np.float64)
    km = rng.integers(-4, 5, (TILE, ch)).astype(np.float64)
    pm = rng.integers(-4, 5, (16, TILE)).astype(np.float64)
    vm = rng.integers(-4, 5, (TILE, ch)).astype(np.float64)
    s = np.zeros((16, TILE))
    for j in range(TILE // 8):           # 8-key n-tiles of S
        for kk in range(ch // 8):        # 8-channel k-steps
            a = [[qm[r, kk * 8 + c] for r, c in a_frag(lane)] for lane in range(32)]
            bk = [[km[j * 8 + n, kk * 8 + c] for c, n in b_frag(lane)] for lane in range(32)]
            s[:, j * 8:j * 8 + 8] += mma_model(a, bk)
    o_perm, o_asis = np.zeros((16, ch)), np.zeros((16, ch))
    for j in range(TILE // 8):           # n-tile j of S is k-step j of P.V
        c = [[pm[r, j * 8 + n] for r, n in c_frag(lane)] for lane in range(32)]
        perm = [[cl[0], cl[2], cl[1], cl[3]] for cl in c]
        for cn in range(ch // 8):
            bv = [[vm[j * 8 + 2 * (lane % 4) + e, cn * 8 + lane // 4] for e in (0, 1)]
                  for lane in range(32)]
            o_perm[:, cn * 8:cn * 8 + 8] += mma_model(perm, bv)
            o_asis[:, cn * 8:cn * 8 + 8] += mma_model(c, bv)
    return s, qm @ km.T, o_perm, o_asis, pm @ vm


def bank_sets(ch):
    """Shared-memory banks of the K reads (key g, channel t and t + 4) and
    the V reads (keys 2t, 2t + 1, channel g) of every fragment, rows padded
    to ch + 4 floats: one list of 32 banks per load instruction."""
    pitch, loads = ch + 4, []
    for j in range(TILE // 8):
        for kk in range(ch // 8):
            for dc in (0, 4):
                loads.append([((j * 8 + lane // 4) * pitch + kk * 8 + lane % 4 + dc) % 32
                              for lane in range(32)])
        for cn in range(ch // 8):
            for e in (0, 1):
                loads.append([((j * 8 + 2 * (lane % 4) + e) * pitch + cn * 8 + lane // 4) % 32
                              for lane in range(32)])
    return loads


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("model", MODELS)
def test_kernel_arithmetic_model(model, shape):
    (q, k, v), plain, xla = _references(shape)
    if model == "tf32_rounding":
        x = torch.cat([q.flatten(), torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                                                  3 * 2 ** -11 + 1, 0.0])])
        r = tf32_rna(x)
        assert not (r.view(torch.int32) & 0x1FFF).any()
        trunc = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
        up = ((x.view(torch.int32) & ~0x1FFF) + 0x2000).view(torch.float32)
        d_t, d_u = (x - trunc).abs(), (up - x).abs()
        assert torch.equal(r, torch.where(d_u <= d_t, up, trunc))  # nearest, ties away from 0
        assert r[-5:].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 0.0]
        assert bool(((x - r).abs() <= 2 ** -11 * x.abs()).all())
        hi, lo = split_tf32(x)
        assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
        assert bool(((x - hi).abs() >= lo.abs()).all())  # truncated toward 0
        assert bool(((x - (hi.double() + lo.double())).abs() <= 2 ** -21 * x.abs()).all())
    elif model == "3xtf32":
        err = _held(kernel_model(q, k, v, passes=3), plain, xla)
        one = float((kernel_model(q, k, v, passes=1) - plain).abs().max())
        assert one > 2 * 1e-4 and err < 1e-5, (one, err)  # one TF32 product breaks the check
    elif model == "online_softmax":
        assert _held(kernel_model(q, k, v, passes=0), plain, xla) < 5e-6
        if shape[1] > TILE:  # the rescale is what makes one pass right
            stale = kernel_model(q, k, v, passes=0, rescale=False)
            assert float((stale - plain).abs().max()) > 1e-2
    else:
        s, qk, o_perm, o_asis, pv = fragment_products(shape)
        assert np.array_equal(s, qk) and np.array_equal(o_perm, pv)
        assert not np.array_equal(o_asis, pv)  # the C layout is not the A layout
        assert all(len(set(banks)) == 32 for banks in bank_sets(shape[3]))


@pytest.mark.parametrize("shape", SHAPES + [(2, 1, 2, 32), (2, 1000, 2, 16)])
def test_kernel_model_matches_plain_and_jax(shape):
    """The whole f32 kernel model (3xTF32, 64-key tiles, one pass) at ragged
    and single-token lengths."""
    (q, k, v), plain, xla = _references(shape)
    assert _held(kernel_model(q, k, v), plain, xla) < 1e-5
