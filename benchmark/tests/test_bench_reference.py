"""The plain reference agrees with the port at the tiny configurations on the
CPU (the port's plain versions there), with one state_dict loaded strictly
into both; and a whole tiny run's check reads float32 rounding only."""
import pytest
import torch

import inputs
import run
import tiny
from reference.latent_hmc import ldm_unet_spec, vq_spec
from reference.pixel_hmc import adm_spec
from reference.unet import UNet
from reference.vq import VQDecode

TOL = dict(atol=2e-4, rtol=1e-3)


def same_weights(port_module, ref_module, index=0):
    shapes = inputs.shapes_of(port_module)
    assert shapes == inputs.shapes_of(ref_module)
    sd = inputs.random_state_dict(shapes, "cpu", 20240917, index)
    port_module.load_state_dict(sd, strict=True)
    ref_module.load_state_dict(sd, strict=True)


def test_adm_unet_forward():
    from nshmc_tpu_torch.models.unet import UNetConfig, UNetModel

    port = UNetModel(UNetConfig.from_model_yaml(**tiny.PIXEL_MODEL), torch.float32)
    ref = UNet(adm_spec(tiny.PIXEL_MODEL))
    same_weights(port, ref)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([750.0, 250.0])
    with torch.no_grad():
        torch.testing.assert_close(ref(x, t), port(x, t), **TOL)


def test_ldm_unet_and_vq_decode():
    from nshmc_tpu_torch.models.ldm import AutoencoderConfig, VQModel, latent_unet_config

    u, fs = tiny.LATENT_MODEL["unet"], tiny.LATENT_MODEL["first_stage"]
    port = __import__("nshmc_tpu_torch.models.unet", fromlist=["UNetModel"]).UNetModel(
        latent_unet_config(image_size=8, model_channels=32, num_res_blocks=1,
                           channel_mult=(1, 2), attention_ds=(2,), num_head_channels=16))
    ref = UNet(ldm_unet_spec(u))
    same_weights(port, ref)
    z = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([500.0, 250.0])
    with torch.no_grad():
        torch.testing.assert_close(ref(z, t), port(z, t), **TOL)

    vq = VQModel(AutoencoderConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
                                   embed_dim=3, n_embed=32, resolution=16))
    rvq = VQDecode(vq_spec(fs))
    dec_shapes = {k: v for k, v in inputs.shapes_of(vq).items()
                  if k.startswith(("decoder.", "quantize.", "post_quant_conv."))}
    assert dec_shapes == inputs.shapes_of(rvq)
    sd = inputs.random_state_dict(dec_shapes, "cpu", 5, 1)
    rvq.load_state_dict(sd, strict=True)
    vq.load_state_dict(sd, strict=False)
    with torch.no_grad():
        torch.testing.assert_close(rvq(z), vq.decode(z), **TOL)


@pytest.mark.parametrize("kind", ["ffhq_adm", "ffhq_ldm"])
@pytest.mark.parametrize("attempt", [0, 2])
def test_tiny_run_checks_at_rounding(kind, attempt):
    """A whole run (set-up, window, check) of a tiny float32 cell, the
    window's first or third attempt sampled: every number of the check at
    float32 rounding."""
    out = run.run_cell(tiny.cell(kind, attempts=(attempt, attempt + 1)), 3141592653589, 0.1, 0,
                       torch.device("cpu"))
    assert out["correct"], out["worst"]
    assert max(out["worst"].values()) < 1e-4, out["worst"]
    w = out["window"]
    assert w.n_evals == 21 * w.attempts and w.nonfinite == 0 and len(w.eval_ms) == w.n_evals
