"""nshmc_tpu_torch's latent stack against the JAX package's: the VQ-f4
autoencoder (Encoder, Decoder, VQModel encode/decode, quantized and not, the
straight-through gradient), AutoencoderKL with DiagonalGaussian, the latent
U-Net at openaimodel's settings, the LDM checkpoint bridge and
DiffusionSchedule.from_alphas_cumprod. Weights are drawn with numpy from a
seed in the JAX layout and carried over by the port's own bridges, at
configs/tiny_latent_test.yaml's sizes. f32 tolerance: tests/test_unet.py's
atol 2e-4, rtol 1e-3."""
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nshmc_tpu.models.ldm import autoencoder as jae
from nshmc_tpu.models.ldm import distributions as jdist
from nshmc_tpu.models.ldm.ldm import latent_unet_config as jax_latent_unet_config
from nshmc_tpu.models.ldm.port import ae_param_mapping as jax_ae_param_mapping
from nshmc_tpu.models.ldm.port import port_ae_state_dict, port_ldm_checkpoint
from nshmc_tpu.models.unet import UNetModel as JaxUNetModel
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch.models.ldm import (AutoencoderConfig, AutoencoderKL, Decoder,
                                        DiagonalGaussian, Encoder, LatentDiffusion, VQModel,
                                        ema_update, latent_unet_config)
from nshmc_tpu_torch.models.ldm.port import (ae_param_mapping, ae_state_dict_from_jax,
                                             split_ldm_checkpoint)
from nshmc_tpu_torch.models.port import state_dict_from_jax
from nshmc_tpu_torch.models.unet import UNetModel
from nshmc_tpu_torch.ops import groupnorm as gn
from nshmc_tpu_torch.schedules import DiffusionSchedule

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATOL, RTOL = 2e-4, 1e-3


def tiny_latent_yaml():
    with open(os.path.join(ROOT, "configs", "tiny_latent_test.yaml")) as f:
        return yaml.safe_load(f)["model"]


def ae_kwargs(**changes):
    fs = tiny_latent_yaml()["first_stage"]
    kw = dict(ch=fs["ch"], ch_mult=tuple(fs["ch_mult"]), num_res_blocks=fs["num_res_blocks"],
              z_channels=fs["z_channels"], embed_dim=fs["embed_dim"], n_embed=fs["n_embed"],
              resolution=fs["resolution"])
    return {**kw, **changes}


def unet_kwargs():
    m = tiny_latent_yaml()
    u = m["unet"]
    return dict(image_size=m["image_size"], model_channels=u["model_channels"],
                num_res_blocks=u["num_res_blocks"], channel_mult=tuple(u["channel_mult"]),
                attention_ds=tuple(u["attention_resolutions"]),
                num_head_channels=u["num_head_channels"])


AE_CASES = {"tiny": {}, "tiny_attn": {"attn_resolutions": (8,)}}  # attention in the levels too


def redraw(params, seed):
    """Every leaf drawn anew with numpy: lecun-normal kernels, GroupNorm
    scales near 1, small biases, a unit-normal codebook."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(x.shape[:-1]))
        elif name == "embedding":
            std = 1.0
        else:
            std = 0.1
        draw = rng.standard_normal(x.shape).astype(np.float32) * std
        return jnp.asarray(draw + (1.0 if name == "scale" else 0.0))

    return jax.tree_util.tree_map_with_path(leaf, params)


def jax_vq(case="tiny", seed=0, model=jae.VQModel, **changes):
    """(JAX module, random params, port config)."""
    kw = ae_kwargs(**AE_CASES[case], **changes)
    jcfg = jae.AutoencoderConfig(**kw)
    jm = model(jcfg)
    # redraw() replaces every leaf, so only the shapes of the init are needed
    params = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                        **({"key": jax.random.PRNGKey(1)} if model is jae.AutoencoderKL else {})))
    return jm, redraw(params, seed), AutoencoderConfig(**kw)


def port_ae(cls, params, cfg):
    m = cls(cfg)
    m.load_state_dict(ae_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg), strict=True)
    return m.eval()


def jax_latent_unet(seed=0):
    jcfg = jax_latent_unet_config(**unet_kwargs())
    jm = JaxUNetModel(jcfg)
    d = jcfg.image_size
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, d, d, 3)),
                            jnp.zeros((1,)))
    return jm, redraw(params, seed), latent_unet_config(**unet_kwargs())


def port_unet(params, cfg):
    m = UNetModel(cfg)
    m.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), cfg), strict=True)
    return m.eval()


def images(seed, n=2, size=16, c=3):
    return np.random.default_rng(seed).standard_normal((n, size, size, c)).astype(np.float32)


def latents(seed, n=2, size=8, c=3):
    return np.random.default_rng(seed).standard_normal((n, size, size, c)).astype(np.float32)


# ---- the autoencoder ---------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(AE_CASES))
def test_ae_state_dict_keys_are_reference_keys(case):
    """The port's parameter names are the keys the JAX package's mapping
    enumerates, with the checkpoint's shapes."""
    _, params, cfg = jax_vq(case)
    sd = VQModel(cfg).state_dict()
    prefixes = jax_ae_param_mapping(jae.AutoencoderConfig(**ae_kwargs(**AE_CASES[case])))
    want = {f"{p}.{n}" for p, kind in prefixes.values()
            for n in (("weight",) if kind == "embed" else ("weight", "bias"))}
    assert set(sd) == want
    assert set(ae_param_mapping(cfg)) == set(prefixes)
    ported = ae_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert {k: tuple(v.shape) for k, v in ported.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert sd["decoder.mid.attn_1.q.weight"].shape[2:] == (1, 1)  # 1x1 Conv2d


@pytest.mark.parametrize("case", sorted(AE_CASES))
@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_encoder_decoder_match_jax(case, part):
    jm, params, cfg = jax_vq(case)
    kw = ae_kwargs(**AE_CASES[case])
    sub = params["params"][part]
    if part == "encoder":
        x, jmod, cls = images(1), jae.Encoder(jae.AutoencoderConfig(**kw)), Encoder
    else:
        x, jmod, cls = latents(1), jae.Decoder(jae.AutoencoderConfig(**kw)), Decoder
    ref = np.asarray(jmod.apply({"params": sub}, jnp.asarray(x)))
    sd = {k[len(part) + 1:]: v for k, v in
          ae_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg).items()
          if k.startswith(part + ".")}
    m = cls(cfg)
    m.load_state_dict(sd, strict=True)
    out = m(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(AE_CASES))
@pytest.mark.parametrize("mode", ["encode", "decode", "decode_not_quantized", "round_trip"])
def test_vqmodel_matches_jax(case, mode):
    jm, params, cfg = jax_vq(case)
    m = port_ae(VQModel, params, cfg)
    if mode == "encode":
        x = images(2)
        ref = jm.apply(params, jnp.asarray(x), method=jae.VQModel.encode)
        out = m.encode(torch.from_numpy(x))
    elif mode == "round_trip":
        x = images(3)
        ref = jm.apply(params, jnp.asarray(x))
        out = m(torch.from_numpy(x))
    else:
        z = latents(4)
        fnq = mode == "decode_not_quantized"
        ref = jm.apply(params, jnp.asarray(z), fnq, method=jae.VQModel.decode)
        out = m.decode(torch.from_numpy(z), force_not_quantize=fnq)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_quantizer_indices_and_straight_through_gradient():
    """The codebook entries the quantizer picks are the JAX quantizer's, its
    output is the codebook entry, and its gradient is the identity (the
    straight-through estimator): so the decode's z-gradient matches JAX's."""
    jm, params, cfg = jax_vq()
    m = port_ae(VQModel, params, cfg)
    z = latents(5)
    codebook = np.asarray(params["params"]["quantize"]["embedding"])
    jq = jae.VectorQuantizer(cfg.n_embed, cfg.embed_dim)
    zq_ref = np.asarray(jq.apply({"params": params["params"]["quantize"]}, jnp.asarray(z)))
    idx = m.quantize.indices(torch.from_numpy(z)).numpy()
    # z + (z_q - z) is z_q up to an ulp, in both frameworks
    np.testing.assert_allclose(codebook[idx].reshape(z.shape), zq_ref, rtol=0, atol=1e-6)
    assert len(np.unique(idx)) > 4  # the lookup is exercised, not one code

    zt = torch.from_numpy(z).requires_grad_(True)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(z.shape).astype(np.float32))
    zq = m.quantize(zt)
    np.testing.assert_array_equal(zq.detach().numpy(), zq_ref)
    (g,) = torch.autograd.grad((w * zq).sum(), zt)
    np.testing.assert_array_equal(g.numpy(), w.numpy())

    def jdecode(zz):
        return jnp.sum(jm.apply(params, zz, method=jae.VQModel.decode) ** 2)

    ref = np.asarray(jax.grad(jdecode)(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    (g,) = torch.autograd.grad((m.decode(zt) ** 2).sum(), zt)
    np.testing.assert_allclose(g.numpy(), ref, atol=ATOL * np.abs(ref).max(), rtol=RTOL)


def test_autoencoder_kl_and_diagonal_gaussian_match_jax():
    jm, params, cfg = jax_vq(model=jae.AutoencoderKL, double_z=True)
    m = port_ae(AutoencoderKL, params, cfg)
    x = images(7)
    jpost = jm.apply(params, jnp.asarray(x), method=jae.AutoencoderKL.encode)
    post = m.encode(torch.from_numpy(x))
    assert isinstance(post, DiagonalGaussian)
    for a, b in ((post.mean, jpost.mean), (post.logvar, jpost.logvar), (post.std, jpost.std),
                 (post.mode(), jpost.mode())):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(post.kl().detach().numpy(), np.asarray(jpost.kl()), rtol=1e-3)
    other = DiagonalGaussian(post.mean * 0.5, post.logvar + 0.3)
    jother = jdist.DiagonalGaussian(jpost.mean * 0.5, jpost.logvar + 0.3)
    np.testing.assert_allclose(post.kl(other).detach().numpy(), np.asarray(jpost.kl(jother)),
                               rtol=1e-3)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, jpost.mean.shape, jpost.mean.dtype))
    sample = post.sample(noise=torch.from_numpy(noise))
    np.testing.assert_allclose(sample.detach().numpy(), np.asarray(jpost.sample(key)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(post.nll(sample).detach().numpy(),
                               np.asarray(jpost.nll(jpost.sample(key))), rtol=1e-3)
    # the whole model: encode, sample with the replayed noise, decode
    ref = jm.apply(params, jnp.asarray(x), key)
    out = m(torch.from_numpy(x), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    moments = np.random.default_rng(8).normal(0, 20, (2, 4, 4, 6)).astype(np.float32)
    clipped = DiagonalGaussian.from_moments(torch.from_numpy(moments)).logvar.numpy()
    np.testing.assert_array_equal(
        clipped, np.asarray(jdist.DiagonalGaussian.from_moments(jnp.asarray(moments)).logvar))


def test_ema_update_matches_jax():
    rng = np.random.default_rng(9)
    ema = {"a": rng.standard_normal((3, 4)).astype(np.float32),
           "b": rng.standard_normal(5).astype(np.float32)}
    new = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in ema.items()}
    ref = jdist.ema_update(ema, new, decay=0.99)
    out = ema_update({k: torch.from_numpy(v) for k, v in ema.items()},
                     {k: torch.from_numpy(v) for k, v in new.items()}, decay=0.99)
    for k in ema:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6)


# ---- GroupNorm at eps 1e-6: a group whose E[x^2] - E[x]^2 rounds below 0 -------------


@pytest.mark.parametrize("shape,seed", [((1, 1, 2, 32), 0), ((2, 1, 2, 32), 1)])
def test_groupnorm_silu_clips_negative_variance_like_flax(shape, seed):
    """x = 1000 + 1e-4 noise: with two elements a group, both frameworks do
    the same f32 operations, and several groups' E[x^2] - E[x]^2 rounds
    negative. flax's GroupNorm clips the variance at 0; the port must too
    (unclipped, rsqrt(var + 1e-6) is NaN)."""
    x = (1000 + 1e-4 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    c = shape[-1]
    x3 = torch.from_numpy(x).reshape(shape[0], -1, c)
    sums = gn.channel_stats_plain(x3)
    n = x3.shape[1]
    raw_var = sums[:, 1] / n - (sums[:, 0] / n) ** 2  # one channel a group here
    assert (raw_var < 0).sum() >= 2  # the case under test occurs
    gnorm = fnn.GroupNorm(num_groups=32, epsilon=1e-6)
    scale = 1 + 0.1 * np.random.default_rng(seed + 1).standard_normal(c).astype(np.float32)
    bias = 0.1 * np.random.default_rng(seed + 2).standard_normal(c).astype(np.float32)
    ref = jax.nn.silu(gnorm.apply({"params": {"scale": jnp.asarray(scale),
                                              "bias": jnp.asarray(bias)}}, jnp.asarray(x)))
    out = gn.groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), 32, 1e-6)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_groupnorm_silu_finite_where_variance_rounds_negative():
    """The same inputs with 16 elements a group: the rounding of the two
    frameworks' sums differs there, but no group gives a NaN."""
    x = (1000 + 1e-4 * np.random.default_rng(2).standard_normal((2, 4, 4, 64))).astype(np.float32)
    mean_c, inv_c = gn.group_combine(gn.channel_stats_plain(torch.from_numpy(x).reshape(2, 16, 64)),
                                     16, 32, 1e-6)
    assert torch.isfinite(inv_c).all() and float(inv_c.max()) == pytest.approx(1000.0, rel=1e-6)
    out = gn.groupnorm_silu(torch.from_numpy(x), torch.ones(64), torch.zeros(64), 32, 1e-6)
    assert torch.isfinite(out).all()


# ---- the latent U-Net, the LDM bundle and its checkpoint -------------------------------


def test_latent_unet_config_matches_jax():
    """openaimodel's settings, at the tiny latent config and at
    configs/ffhq_latent.yaml's (the defaults)."""
    for kw in (unet_kwargs(), {}):
        ours, ref = latent_unet_config(**kw), jax_latent_unet_config(**kw)
        for f in dataclasses.fields(ours):
            if f.name not in ("remat", "remat_min_res"):
                # a field the JAX config lacks (SD 2's linear projections) stays at its default
                want = getattr(ref, f.name) if hasattr(ref, f.name) else f.default
                assert getattr(ours, f.name) == want, f.name
    cfg = latent_unet_config()
    assert (cfg.num_heads, cfg.num_head_channels, cfg.out_channels) == (1, 32, 3)
    assert not cfg.use_scale_shift_norm and not cfg.resblock_updown
    # the attention blocks' channels at ds 2, 4, 8 -> 14, 21, 28 heads of 32
    assert [cfg.model_channels * m // 32 for m in cfg.channel_mult[1:]] == [14, 21, 28]


@pytest.mark.parametrize("grad", [False, True])
def test_latent_unet_matches_jax(grad):
    jm, params, cfg = jax_latent_unet()
    m = port_unet(params, cfg)
    z = latents(10)
    t = np.asarray([25.0, 75.0], np.float32)
    if not grad:
        ref = jm.apply(params, jnp.asarray(z), jnp.asarray(t))
        out = m(torch.from_numpy(z), torch.from_numpy(t))
        assert out.shape == (2, 8, 8, 3)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        return
    ref = jax.grad(lambda zz: jnp.sum(jm.apply(params, zz, jnp.asarray(t)) ** 2))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    (g,) = torch.autograd.grad((m(zt, torch.from_numpy(t)) ** 2).sum(), zt)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_latent_unet_modules_at_openaimodel_settings():
    """Conv Downsample/Upsample, no scale-shift, one head per block of
    num_head_channels channels."""
    from nshmc_tpu_torch.models.unet import AttentionBlock, Downsample, ResBlock, Upsample

    m = UNetModel(latent_unet_config(**unet_kwargs()))
    mods = list(m.modules())
    assert any(isinstance(x, Downsample) and x.op is not None for x in mods)
    assert any(isinstance(x, Upsample) and x.conv is not None for x in mods)
    assert not any(isinstance(x, ResBlock) and (x.up or x.down or x.use_scale_shift_norm)
                   for x in mods)
    assert {x.heads for x in mods if isinstance(x, AttentionBlock)} == {64 // 16}


def _ldm_from_jax(seed=0):
    _, uparams, ucfg = jax_latent_unet(seed)
    _, aparams, acfg = jax_vq(seed=seed + 1)
    ldm = LatentDiffusion(ucfg, acfg, DiffusionSchedule.create("quad", 0.0015, 0.0195, 100,
                                                               device="cpu"))
    ldm.unet.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, uparams), ucfg))
    ldm.first_stage.load_state_dict(ae_state_dict_from_jax(jax.tree.map(np.asarray, aparams),
                                                           acfg))
    return ldm, uparams, aparams


@pytest.mark.parametrize("case", sorted(AE_CASES))
def test_ae_state_dict_round_trip(case):
    """port state_dict -> the JAX package's porter reproduces the params
    exactly."""
    _, params, cfg = jax_vq(case)
    sd = port_ae(VQModel, params, cfg).state_dict()
    back = port_ae_state_dict({k: v.numpy() for k, v in sd.items()},
                              jae.AutoencoderConfig(**ae_kwargs(**AE_CASES[case])))
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    leaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat[path]))


def test_ldm_checkpoint_round_trip():
    """LatentDiffusion's state_dict has the Lightning checkpoint's prefixes:
    with the schedule buffer and training-only keys beside it, the JAX
    package's port_ldm_checkpoint recovers both models' params and the
    table exactly, and the port loads it back (strict) to the same state."""
    ldm, uparams, aparams = _ldm_from_jax()
    sd = {k: v.clone() for k, v in ldm.state_dict().items()}
    assert {k.split(".")[0] for k in sd} == {"model", "first_stage_model"}
    ac = DiffusionSchedule.create("quad", 0.0015, 0.0195, 100, device="cpu").alphas_cumprod
    ckpt = {**sd, "alphas_cumprod": ac.double() * 0.999, "betas": torch.zeros(100),
            "first_stage_model.loss.logvar": torch.zeros(())}
    jucfg = jax_latent_unet_config(**unet_kwargs())
    up, ap, jac = port_ldm_checkpoint({k: v.numpy() for k, v in ckpt.items()}, jucfg,
                                      jae.AutoencoderConfig(**ae_kwargs()))
    for got, want in ((up, uparams), (ap, aparams)):
        flat = dict(jax.tree_util.tree_leaves_with_path(want))
        leaves = jax.tree_util.tree_leaves_with_path(got)
        assert len(leaves) == len(flat)
        for path, leaf in leaves:
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat[path]))
    unet_sd, ae_sd, ours_ac = split_ldm_checkpoint(ckpt)
    np.testing.assert_array_equal(ours_ac, jac)
    assert len(unet_sd) + len(ae_sd) == len(sd)

    other = LatentDiffusion(ldm.unet.cfg, ldm.first_stage.cfg,
                            DiffusionSchedule.create("quad", 0.0015, 0.0195, 100, device="cpu"))
    other.load_checkpoint(ckpt)
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k
    np.testing.assert_allclose(other.schedule.alphas_cumprod.numpy(), jac, rtol=1e-7)


def test_apply_model_stop_gradient():
    """The default eps-net call builds no graph (a constant to backward);
    stop_gradient=False differentiates through it."""
    ldm, _, _ = _ldm_from_jax()
    z = torch.from_numpy(latents(11)).requires_grad_(True)
    t = torch.tensor([50.0, 50.0])
    assert not ldm.apply_model(z, t).requires_grad
    assert not ldm.model_fn()(z, t).requires_grad
    out = ldm.model_fn(stop_gradient=False)(z, t)
    assert out.requires_grad
    torch.testing.assert_close(out.detach(), ldm.apply_model(z, t))
    assert all(not p.requires_grad for p in ldm.parameters())  # frozen
    x = ldm.decode_first_stage(z)
    assert x.requires_grad and x.shape == (2, 16, 16, 3)  # the decode stays differentiable


# ---- the schedule -------------------------------------------------------------------------


def test_from_alphas_cumprod_matches_jax_and_ldm_linear():
    """A registered LDM table rebuilds the JAX package's schedule, and LDM's
    'linear' schedule (a linspace in sqrt space) is the 'quad' one."""
    ls, le, n = 0.0015, 0.0195, 1000
    ldm_betas = np.linspace(ls**0.5, le**0.5, n, dtype=np.float64) ** 2
    table = np.cumprod(1.0 - ldm_betas)
    ours = DiffusionSchedule.from_alphas_cumprod(table, device="cpu")
    ref = JaxSched.from_alphas_cumprod(table)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_padded"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    quad = DiffusionSchedule.create("quad", ls, le, n, device="cpu")
    np.testing.assert_array_equal(quad.alphas_cumprod.numpy(), ours.alphas_cumprod.numpy())
    np.testing.assert_allclose(ours.betas.numpy(), ldm_betas, rtol=1e-5)
    assert float(ours.alpha_bar(-1)) == 1.0
