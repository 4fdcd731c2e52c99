"""nshmc_tpu_torch's Stable Diffusion 2 path on the CPU at tiny widths:
the linear-projection SpatialTransformer (SD 2's use_linear_in_transformer)
against the 1x1-conv one with the same weights; the self-attention through
ops/attention.py::attention (the kernel K1 on the card); LatentDiffusion with
the KL first stage, its scale_factor, dtype and held context (copied in
place, shared by the chains, what the DDIM decoder's graphs observe); a
Lightning checkpoint with SD 2's key shapes and the text encoder's keys
loaded strictly; configs/sd21_base_latent.yaml's reading; and the latent CLI
end to end with a tiny SD config, its context seeded or read from a file."""
import copy
import json
import types

import numpy as np
import pytest
import torch
import yaml

from nshmc_tpu_torch import cli
from nshmc_tpu_torch.cli_latent import build_latent_model, latent_configs
from nshmc_tpu_torch.hmc import latent
from nshmc_tpu_torch.models.ldm import AutoencoderKL, LatentDiffusion
from nshmc_tpu_torch.models.ldm import port as ldm_port
from nshmc_tpu_torch.models.ldm import transformer as ttr
from nshmc_tpu_torch.ops import attention as k1
from nshmc_tpu_torch.utils import profiling
from test_torch_cli import _synthetic_dataset

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_unet.py's bar: f32 sums in other orders
SD_YAML = "configs/sd21_base_latent.yaml"
with open("configs/tiny_sd_test.yaml") as _f:
    TINY = yaml.safe_load(_f)


def tiny_ldm(cfg=TINY, seed=0):
    ldm, ucfg = build_latent_model(cfg, types.SimpleNamespace(ckpt="", seed=seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in ldm.state_dict().items():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / np.sqrt(p[0].numel()))
            elif p.is_floating_point() and "context" not in name:
                p.copy_(0.05 * torch.randn(p.shape, generator=g) + (name.endswith("weight")))
    return ldm, ucfg


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("with_context", [False, True])
def test_linear_projections_equal_the_conv_ones(depth, with_context):
    """proj_in / proj_out as linear layers on the tokens compute what 1x1
    convolutions with the same weights compute."""
    ctx_dim = 24 if with_context else None
    lin = ttr.SpatialTransformer(32, 2, 16, depth, ctx_dim, use_linear=True)
    conv = ttr.SpatialTransformer(32, 2, 16, depth, ctx_dim)
    g = torch.Generator().manual_seed(depth)
    sd = {k: torch.randn(v.shape, generator=g) * 0.2 for k, v in lin.state_dict().items()}
    assert sd["proj_in.weight"].shape == (32, 32) and lin.proj_out.weight.shape == (32, 32)
    lin.load_state_dict(sd, strict=True)
    conv.load_state_dict({k: v[..., None, None] if k.startswith("proj_") and v.dim() == 2 else v
                          for k, v in sd.items()}, strict=True)
    x = torch.randn(2, 32, 4, 4, generator=g).contiguous(memory_format=torch.channels_last)
    ctx = torch.randn(2, 5, 24, generator=g) if with_context else None
    torch.testing.assert_close(lin(x, ctx), conv(x, ctx), **TOL)


@pytest.mark.parametrize("d_head", [8, 16, 64])
def test_self_attention_goes_through_k1(monkeypatch, d_head):
    """attn1 calls ops/attention.py::attention (its plain version on the
    CPU, the kernel on the card) and gives the plain-torch block's output;
    cross-attention does not."""
    calls = []
    real = k1.attention
    monkeypatch.setattr(k1, "attention", lambda q, k, v: calls.append(q.shape) or real(q, k, v))
    block = ttr.BasicTransformerBlock(2 * d_head, 2, d_head, context_dim=12)
    g = torch.Generator().manual_seed(d_head)
    x = torch.randn(2, 9, 2 * d_head, generator=g)
    ctx = torch.randn(2, 3, 12, generator=g)
    a = block.attn1(x)
    assert calls == [(2, 9, 2, d_head)]
    block.attn2(x, ctx)
    assert len(calls) == 1
    # the same weights through the plain-torch path (a context equal to x)
    torch.testing.assert_close(a, ttr.CrossAttention.forward(block.attn1, x, x), **TOL)


def test_kl_first_stage_and_scale_factor():
    ldm, _ = tiny_ldm()
    assert isinstance(ldm.first_stage, AutoencoderKL)
    z = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(3))
    img = ldm.decode_first_stage(z)
    assert img.shape == (2, 16, 16, 3) and img.dtype == torch.float32
    torch.testing.assert_close(img, ldm.first_stage.decode(z / 0.18215), rtol=0, atol=0)
    x = torch.rand(1, 16, 16, 3)
    torch.testing.assert_close(ldm.encode_first_stage(x),
                               ldm.first_stage.encode(x).mode() * 0.18215, rtol=0, atol=0)


def test_decoder_takes_any_latent_size():
    """The KL decoder derives no shape from `resolution` (SD's 256, its
    training crop): a 16^2 latent decodes to 32^2 at resolution 8."""
    ldm, _ = tiny_ldm()
    assert ldm.decode_first_stage(torch.zeros(1, 16, 16, 4)).shape == (1, 32, 32, 3)


def test_bf16_dtype_from_the_config():
    cfg = copy.deepcopy(TINY)
    cfg["model"]["dtype"] = "bfloat16"
    ldm, _ = tiny_ldm(cfg)
    assert ldm.unet.input_blocks[1][1].proj_in.weight.dtype == torch.bfloat16
    assert ldm.first_stage.decoder.conv_in.weight.dtype == torch.bfloat16
    assert ldm.unet.input_blocks[1][1].norm.weight.dtype == torch.float32
    eps = ldm.apply_model(torch.randn(2, 8, 8, 4), torch.tensor([500.0, 250.0]))
    assert eps.dtype == torch.float32 and torch.isfinite(eps).all()


def test_context_is_held_in_place_and_shared():
    ldm, _ = tiny_ldm()
    held = ldm.model.context
    assert held.shape == (1, 77, 24)
    z, t = torch.randn(3, 8, 8, 4), torch.tensor([500.0] * 3)
    new = torch.randn(77, 24)
    ldm.set_context(new)
    assert ldm.model.context is held and torch.equal(held[0], new)
    want = ldm.unet(z, t, context=new[None].expand(3, -1, -1))
    torch.testing.assert_close(ldm.apply_model(z, t), want, rtol=0, atol=0)
    fn = ldm.model_fn()
    assert fn.module is ldm.model and "context" not in ldm.state_dict()
    ldm.set_context(torch.randn(1, 7, 24))  # another shape: a new buffer
    assert ldm.model.context is not held and ldm.model.context.shape == (1, 7, 24)
    with pytest.raises(ValueError):
        ldm.set_context(torch.randn(1, 5, 23))
    vq = LatentDiffusion.create(device="cpu")
    assert vq.model_fn().module is vq.unet


def test_conditional_model_needs_a_context():
    ldm = LatentDiffusion.create(*latent_configs(TINY), device="cpu")
    with pytest.raises(ValueError, match="set_context"):
        ldm.apply_model(torch.zeros(1, 8, 8, 4), torch.tensor([10.0]))


def test_sd_checkpoint_loads_strictly(tmp_path):
    """A Lightning checkpoint with SD 2's keys: linear proj_in / proj_out
    (inner, C), the KL first stage, the schedule's buffers and the OpenCLIP
    text encoder's cond_stage_model.* keys, which are not read."""
    ldm, _ = tiny_ldm()
    sd = {f"model.diffusion_model.{k}": v + 0.5 for k, v in ldm.unet.state_dict().items()}
    sd.update({f"first_stage_model.{k}": v - 0.5 for k, v in ldm.first_stage.state_dict().items()})
    assert sd["model.diffusion_model.input_blocks.1.1.proj_in.weight"].shape == (32, 32)
    sd["cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight"] = torch.ones(3, 3)
    sd["cond_stage_model.model.positional_embedding"] = torch.ones(77, 8)
    sd["alphas_cumprod"] = torch.from_numpy(np.linspace(0.99, 0.01, 100))
    sd["betas"] = torch.zeros(100)
    unet_sd, ae_sd, _ = ldm_port.split_ldm_checkpoint(sd)
    assert not any(k.startswith("cond_stage_model") for k in (*unet_sd, *ae_sd))
    path = tmp_path / "sd.ckpt"
    torch.save({"state_dict": sd}, path)
    cfg = copy.deepcopy(TINY)
    cfg["model"]["ckpt_path"] = str(path)
    loaded, _ = build_latent_model(cfg, types.SimpleNamespace(ckpt="", seed=0), "cpu")
    for k, v in loaded.unet.state_dict().items():
        assert torch.equal(v, sd[f"model.diffusion_model.{k}"]), k
    for k, v in loaded.first_stage.state_dict().items():
        assert torch.equal(v, sd[f"first_stage_model.{k}"]), k
    broken = dict(sd)
    broken.pop("model.diffusion_model.input_blocks.1.1.proj_out.bias")
    with pytest.raises(RuntimeError):
        ldm.load_checkpoint(broken)


def test_sd21_yaml_at_the_published_widths():
    with open(SD_YAML) as f:
        cfg = yaml.safe_load(f)
    ucfg, ae = latent_configs(cfg)
    assert (ucfg.model_channels, ucfg.channel_mult, ucfg.attention_ds, ucfg.num_head_channels,
            ucfg.context_dim, ucfg.use_linear_in_transformer, ucfg.in_channels,
            ucfg.image_size) == (320, (1, 2, 4, 4), (4, 2, 1), 64, 1024, True, 4, 64)
    assert ae.double_z and (ae.ch, ae.ch_mult, ae.embed_dim, ae.z_channels) == \
        (128, (1, 2, 4, 4), 4, 4)
    m = cfg["model"]
    assert (m["scale_factor"], m["dtype"], m["linear_start"], m["linear_end"]) == \
        (0.18215, "bfloat16", 0.00085, 0.012)
    with torch.device("meta"):
        ldm = LatentDiffusion(ucfg, ae, dtype=torch.bfloat16)
    assert sum(p.numel() for p in ldm.unet.parameters()) == 865_910_724  # SD 2's U-Net


@pytest.mark.parametrize("kind", ["seeded", "pt", "npy"])
def test_context_source(tmp_path, capsys, kind):
    cfg = copy.deepcopy(TINY)
    want = torch.randn((1, 77, 24), generator=torch.Generator().manual_seed(11))
    if kind == "pt":
        cfg["model"]["context_path"] = str(tmp_path / "ctx.pt")
        torch.save(want[0].clone(), cfg["model"]["context_path"])
    elif kind == "npy":
        cfg["model"]["context_path"] = str(tmp_path / "ctx.npy")
        np.save(cfg["model"]["context_path"], want.numpy())
    ldm, _ = build_latent_model(cfg, types.SimpleNamespace(ckpt="", seed=11), "cpu")
    assert torch.equal(ldm.model.context, want)
    printed = capsys.readouterr().out
    assert ("seeded N(0, 1) context" in printed) == (kind == "seeded")


def test_loss_decode_is_the_kl_span_timed():
    """The latent loss opens `kl.decode` (timed: no CUDA events on the CPU)
    around the KL decode while a profiler runs."""
    ldm, ucfg = tiny_ldm()

    class Op:
        def H_img(self, img):
            return img.reshape(len(img), -1)

    loss = latent.make_latent_loss_fn(lambda z: z, ldm.decode_first_stage, Op(),
                                      torch.zeros(16 * 16 * 3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = __import__("time").time_ns()
        loss(torch.zeros(1, 8, 8, 4))
        found = profiling.spans(t0, __import__("time").time_ns())
    kl = [s for s in found if s.name == "kl.decode"]
    assert len(kl) == 1 and kl[0].events is None and profiling.device_ms(kl[0]) is None
    assert sum(s.name == "ldm.transformer" for s in found) == 0  # no eps-net in this loss


def test_cli_runs_a_tiny_sd_config(tmp_path, capsys):
    """--algo hmc_latent with a tiny SD-shaped config (KL first stage,
    conditional U-Net, linear projections, seeded context) end to end."""
    data = _synthetic_dataset(tmp_path / "data")
    summary = cli.main([
        "--config", "configs/tiny_sd_test.yaml", "-i", str(tmp_path / "out"), "--data_path", str(data),
        "--device", "cpu", "--no-bf16", "--algo", "hmc_latent", "--deg", "inpaint_random",
        "--chains", "2", "--tau", "0.1", "--epsilon", "0.05", "--latent_epochs", "1",
        "--latent_sampling", "1"])
    assert np.isfinite(summary["psnr"])
    printed = capsys.readouterr().out
    assert "seeded N(0, 1) context (1, 77, 24)" in printed
    assert json.loads(printed.strip().splitlines()[-1]) == {"summary": summary}


@pytest.mark.parametrize("c,chunks", [(320, 1), (2048, 1), (2560, 2), (4096, 2)])
def test_k2a_channel_chunks_of_whole_groups(c, chunks):
    """K2a cuts a call wider than its 2048 channels (SD's 2560-channel
    decoder inputs) into chunks of whole groups: the wrapper's chunking
    (`by_channel_chunks`, here over the plain statistics in place of the
    launch) gives the whole call's statistics."""
    from nshmc_tpu_torch.ops import groupnorm as gn

    assert gn.stats_channel_chunks(c, gn.NUM_GROUPS) == chunks
    x = torch.randn(2, 12, c, generator=torch.Generator().manual_seed(c)) * 3 + 1
    whole = gn.group_stats_plain(x, gn.NUM_GROUPS, 1e-5)
    seen = []

    def stats(xc, groups):
        seen.append((tuple(xc.shape), groups, xc.is_contiguous()))
        return gn.group_stats_plain(xc, groups, 1e-5)

    got = gn.by_channel_chunks(x, chunks, gn.NUM_GROUPS, stats)
    assert seen == [((2, 12, c // chunks), gn.NUM_GROUPS // chunks, True)] * chunks
    for a, b in zip(whole, got):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
