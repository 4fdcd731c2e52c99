"""The meta-device FLOP count (flops.py) equals an analytic count of the tiny
ADM U-Net: its forward, and one energy + input gradient of the 3-step
decoder (convolutions and token linears differentiated for their input
only, both operands of each attention product, no gradient into the
timestep embedding)."""
import torch

import flops
import tiny
from reference.pixel_hmc import PixelProblem, adm_spec
from reference.unet import UNet


def analytic(spec, b):
    """(forward FLOPs, FLOPs of the input gradient) of one U-Net call."""
    mc, td = spec.model_channels, 4 * spec.model_channels
    fwd = emb = 2 * b * (mc * td + td * td)
    bwd = 0
    conv = lambda r, ci, co, k=3: 2 * b * r * r * ci * co * k * k
    r = spec.image_size
    c = spec.channel_mult[0] * mc
    fwd += conv(r, spec.in_channels, c)
    bwd += conv(r, spec.in_channels, c)

    def res(r_out, ci, co):
        nonlocal fwd, bwd, emb
        f = conv(r_out, ci, co) + conv(r_out, co, co) + (conv(r_out, ci, co, 1) if ci != co else 0)
        e = 2 * b * td * (2 * co if spec.use_scale_shift_norm else co)
        fwd, bwd, emb = fwd + f + e, bwd + f, emb + e

    def attn(r, ch):
        nonlocal fwd, bwd
        t, heads = r * r, ch // spec.num_head_channels
        lin = 2 * b * t * ch * 3 * ch + 2 * b * t * ch * ch
        mm = 2 * (2 * b * heads * t * t * spec.num_head_channels)
        fwd, bwd = fwd + lin + mm, bwd + lin + 2 * mm

    chans, ds = [c], 1
    for level, mult in enumerate(spec.channel_mult):
        for _ in range(spec.num_res_blocks):
            res(r, c, mult * mc)
            c = mult * mc
            if ds in spec.attention_ds:
                attn(r, c)
            chans.append(c)
        if level != len(spec.channel_mult) - 1:
            r //= 2
            res(r, c, c)
            chans.append(c)
            ds *= 2
    res(r, c, c)
    attn(r, c)
    res(r, c, c)
    for level, mult in reversed(list(enumerate(spec.channel_mult))):
        for i in range(spec.num_res_blocks + 1):
            res(r, c + chans.pop(), mult * mc)
            c = mult * mc
            if ds in spec.attention_ds:
                attn(r, c)
            if level and i == spec.num_res_blocks:
                r *= 2
                res(r, c, c)
                ds //= 2
    fwd += conv(r, c, spec.out_channels)
    bwd += conv(r, c, spec.out_channels)
    return fwd, bwd


def test_forward_count():
    spec = adm_spec(tiny.PIXEL_MODEL)
    with torch.device("meta"):
        net = UNet(spec)
        x, t = torch.zeros(3, 16, 16, 3), torch.zeros(3)
    with torch.no_grad():
        assert flops.count(net, x, t) == analytic(spec, 3)[0]


def test_evaluation_count():
    cell = tiny.cell("ffhq_adm", chains=4)
    spec = adm_spec(tiny.PIXEL_MODEL)
    fwd, bwd = analytic(spec, 4)
    got = flops.per_eval(PixelProblem, cell.config, cell.traffic, (16, 16, 3))
    assert got == 3 * (fwd + bwd)
