"""Where the latent path meets the kernels, checked on the CPU: the GN+SiLU
sites and attention blocks that kernel_check and chip_smoke.py hold the
kernels to at configs/ffhq_latent.yaml's widths (counted here by forward
hooks at the same depths and resolutions with the widths cut by a whole
factor), and how the GN+SiLU backward wrapper cuts a call too wide for its
kernels' row layout into chunks of whole groups."""
import dataclasses

import numpy as np
import pytest
import torch

from nshmc_tpu_torch.models.ldm import AutoencoderConfig, Decoder, latent_unet_config
from nshmc_tpu_torch.models.unet import UNetModel
from nshmc_tpu_torch.ops import groupnorm as gn
from nshmc_tpu_torch.scripts import kernel_check as kc

torch.set_num_threads(2)

SMS = 132  # the H100's SMs


def _scaled(sites, factor, batch=8):
    """Site shapes counted at batch 1 and 1/factor of the widths -> the
    full-width shapes at `batch` chains."""
    out = {}
    for key, n in sites.items():  # (B, R, C) or, for attention, (B, T, heads, ch)
        full = (batch, key[1], key[2] * factor, *key[3:])
        out[full] = out.get(full, 0) + n
    return out


def test_vq_decoder_sites():
    """The decoder's 23 GN+SiLU sites and its one GroupNorm32 (ch 128
    counted at ch 32)."""
    cfg = AutoencoderConfig()  # configs/ffhq_latent.yaml's first stage
    dec = Decoder(dataclasses.replace(cfg, ch=cfg.ch // 4)).eval()
    z = torch.zeros((1, 64, 64, cfg.z_channels))
    with torch.no_grad():
        gn_sites, attn_sites, norm_sites = kc.count_sites(dec, lambda: dec(z))
    assert _scaled(gn_sites, 4) == kc.VQ_DECODER_GN_SITES
    assert _scaled(norm_sites, 4) == kc.VQ_DECODER_NORM_SITES  # the mid-block AttnBlock
    assert not attn_sites  # its one attention block is the AE's own, not K1's
    elems = sum(b * r * c * n for (b, r, c), n in kc.VQ_DECODER_GN_SITES.items())
    assert elems == 939_524_096  # 0.94 G elements a decode at 8 chains


def test_latent_unet_sites():
    """The latent U-Net's 45 GN+SiLU sites and 16 attention blocks, each
    with a GroupNorm32 (ch 224
    counted at ch 32: heads of 32 channels, so 2, 3, 4 heads for 14, 21,
    28)."""
    cfg = dataclasses.replace(latent_unet_config(), model_channels=32)
    unet = UNetModel(cfg).eval()
    x = torch.zeros((1, 64, 64, 3))
    with torch.no_grad():
        gn_sites, attn_sites, norm_sites = kc.count_sites(
            unet, lambda: unet(x, torch.full((1,), 500.0)))
    assert _scaled(gn_sites, 7) == kc.LATENT_UNET_GN_SITES
    assert _scaled(norm_sites, 7) == kc.LATENT_UNET_NORM_SITES  # one an attention block
    assert _scaled(attn_sites, 7) == kc.LATENT_ATTN_SITES
    assert set(kc.LATENT_ATTN_SHAPES) <= set(kc.ATTN_SHAPES)
    assert (8, 1024, 8, 32) not in kc.ATTN_SHAPES  # not a shape of any path


@pytest.mark.parametrize("c,dtype_size,chunks", [
    (1792, 4, 2), (1568, 4, 2), (1344, 4, 2), (1120, 4, 2), (896, 4, 1), (1024, 4, 1),
    (1792, 2, 1), (2048, 2, 1), (4096, 2, 2), (4096, 4, 4)])
def test_bwd_channel_chunks(c, dtype_size, chunks):
    """One kernel call up to 256 16-byte vectors a row, else the fewest
    chunks of whole groups that fit, each a multiple of 8 channels."""
    n = gn.bwd_channel_chunks(c, 32, dtype_size)
    assert n == chunks
    assert 32 % n == 0 and (c // n) % 8 == 0 and c // n <= 256 * 16 // dtype_size


@pytest.mark.parametrize("shape", [(2, 16, 1792), (2, 16, 1120)])
def test_backward_in_group_chunks_equals_the_whole(shape):
    """The GN+SiLU backward of C channels equals that of its chunks of whole
    groups, each with its share of the groups, concatenated: the wrapper's
    split is exact (here through the plain version)."""
    b, r, c = shape
    rng = np.random.default_rng(0)
    x, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(x), r)
    for aff in ((c,), (b, c)):
        scale = torch.from_numpy(1 + 0.3 * rng.standard_normal(aff).astype(np.float32))
        bias = torch.from_numpy(0.3 * rng.standard_normal(aff).astype(np.float32))
        whole = gn.groupnorm_silu_backward_plain(x, g, mean_c, inv_c, scale, bias)
        n = gn.bwd_channel_chunks(c, 32, 4)
        w = c // n
        parts = [gn.groupnorm_silu_backward_plain(
            *(t[..., i * w:(i + 1) * w].contiguous() for t in (x, g, mean_c, inv_c, scale, bias)),
            32 // n) for i in range(n)]
        for got, want in zip((torch.cat(p, dim=-1) for p in zip(*parts)), whole):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_bwd_designs_at_the_latent_sites():
    """Every latent site has a way through K2c: a design in one call, or the
    wrapper's channel chunks (f32 only, C > 1024); the wrapper's pick is
    among the designs that can take the call."""
    for _, sites in kc.LATENT_GN_SITES.values():
        for shape in sites:
            for size in (2, 4):
                designs = gn.bwd_designs(*shape, size, SMS)
                if designs:
                    assert gn.bwd_design(*shape, size, SMS) in designs
                else:
                    assert size == 4 and shape[2] > 1024
                    chunk = (shape[0], shape[1], shape[2] // gn.bwd_channel_chunks(shape[2], 32, 4))
                    assert gn.bwd_designs(*chunk, size, SMS)
