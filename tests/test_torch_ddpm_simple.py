"""nshmc_tpu_torch's DDPM "simple" U-Net (the CelebA-HQ prior) against the
JAX package: the same random weights (numpy, from a seed, carried over by
`ddpm_state_dict_from_jax`) and the same inputs through both, on
tests/test_ddpm_simple.py's TINY config, f32, at tests/test_unet.py's bar
(atol 2e-4, rtol 1e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.models import ddpm_simple as jd
from nshmc_tpu_torch.models import ddpm_simple as td
from test_torch_ldm import redraw

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=1e-3)
TINY = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            in_channels=3, resolution=16)


def jax_ddpm(seed=0, **changes):
    """(JAX DDPMModel, random params, the port's model with them)."""
    kw = dict(TINY, **changes)
    jm = jd.DDPMModel(jd.DDPMConfig(**kw))
    params = redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                   jnp.zeros((1,))), seed)
    cfg = td.DDPMConfig(**kw)
    tm = td.DDPMModel(cfg)
    tm.load_state_dict(td.ddpm_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg),
                       strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("dim", [32, 33, 7])
def test_timestep_embedding_matches_jax(dim):
    """[sin | cos], 1/(half - 1) spacing, odd dims zero-padded. XLA's and
    torch's f32 sin/cos differ by up to ~1.5e-5 at arguments near 999 rad
    (the argument's own f32 ulp is 6e-5 there): atol 5e-5."""
    t = np.asarray([0.0, 10.0, 500.0, 999.0], np.float32)
    ref = np.asarray(jd.ddpm_timestep_embedding(jnp.asarray(t), dim))
    out = td.ddpm_timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert out.shape == (4, dim)
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=0)


@pytest.mark.parametrize("changes", [{}, dict(num_res_blocks=2, ch_mult=(1, 1, 2))],
                         ids=["tiny", "two_blocks"])
def test_state_dict_keys_are_the_mapping(changes):
    """The port's keys are the torch names of the JAX package's
    ddpm_param_mapping (nin_shortcut only where the widths differ), with
    the reference's shapes."""
    cfg = td.DDPMConfig(**dict(TINY, **changes))
    sd = td.DDPMModel(cfg).state_dict()
    mapping = jd.ddpm_param_mapping(jd.DDPMConfig(**dict(TINY, **changes)))
    assert {k.rsplit(".", 1)[0] for k in sd} == {p for p, _ in mapping.values()}
    assert set(td.ddpm_param_mapping(cfg).values()) == set(mapping.values())
    assert sd["temb.dense.0.weight"].shape == (4 * cfg.ch, cfg.ch)
    assert sd["conv_in.weight"].shape == (cfg.ch, 3, 3, 3)


def test_round_trip_through_port_ddpm_state_dict():
    """The port's state_dict through the JAX porter gives back the JAX
    params exactly."""
    _, params, tm = jax_ddpm(seed=5)
    back = jd.port_ddpm_state_dict(tm.state_dict(), jd.DDPMConfig(**TINY))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_forward_and_input_gradient_match_jax():
    jm, params, tm = jax_ddpm()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.asarray([10.0, 900.0], np.float32)

    def jloss(xx):
        out = jm.apply(params, xx, jnp.asarray(t))
        return jnp.sum(out ** 2), out

    ref_g, ref = jax.jit(jax.grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(t))
    (g,) = torch.autograd.grad((out ** 2).sum(), xt)
    assert out.shape == (2, 16, 16, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), **TOL)
    assert all(not p.requires_grad for p in tm.parameters())  # a frozen prior


def test_bf16_torso_close_to_f32():
    """bf16 convolutions and linears, fp32 norms: within 5% of the f32
    output's scale (bf16 keeps 8 bits of mantissa through ~20 layers)."""
    _, _, tm = jax_ddpm()
    cfg = td.DDPMConfig(**TINY)
    m16 = td.DDPMModel(cfg, dtype=torch.bfloat16)
    m16.load_state_dict(tm.state_dict())
    assert m16.conv_in.weight.dtype == torch.bfloat16
    assert m16.norm_out.weight.dtype == torch.float32
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(np.float32))
    t = torch.tensor([10.0, 900.0])
    out32, out16 = tm(x, t), m16(x, t)
    assert out16.dtype == torch.float32
    assert float((out16 - out32).abs().max()) <= 0.05 * float(out32.abs().max())


def test_load_ddpm_checkpoint_sets_logvar_aside(tmp_path):
    """A reference checkpoint carries `logvar`: it is set aside and every
    other key loads strictly; a missing key raises."""
    _, _, tm = jax_ddpm(seed=6)
    sd = dict(tm.state_dict(), logvar=torch.zeros(1000))
    path = tmp_path / "celeba_hq.ckpt"
    torch.save(sd, path)
    cfg = td.DDPMConfig(**TINY)
    loaded = td.load_ddpm_checkpoint(str(path), cfg, device="cpu")
    assert not loaded.training and next(loaded.parameters()).device.type == "cpu"
    for k, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    del sd["conv_out.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        td.load_ddpm_checkpoint(str(path), cfg, device="cpu")


def test_sites_are_kernel_check_tables():
    """The CelebA-HQ DDPM's GN+SiLU and GroupNorm32 sites, counted by hooks
    at DDPMConfig's depths and resolution with ch 128 cut to 32, are
    kernel_check's DDPM tables (which chip_smoke.py holds at full width)
    scaled back; each GN+SiLU shape is one of the flagship's, and no
    attention block runs K1."""
    import dataclasses

    from nshmc_tpu_torch.scripts import kernel_check as kc

    m = td.DDPMModel(dataclasses.replace(td.DDPMConfig(), ch=32)).eval()
    with torch.no_grad():
        gn_sites, attn_sites, norm_sites = kc.count_sites(
            m, lambda: m(torch.zeros((1, 256, 256, 3)), torch.full((1,), 500.0)))

    def scaled(sites):
        return {(8, r, 4 * c): n for (_, r, c), n in sites.items()}

    assert scaled(gn_sites) == kc.DDPM_GN_SITES and sum(kc.DDPM_GN_SITES.values()) == 65
    assert scaled(norm_sites) == kc.DDPM_NORM_SITES and not attn_sites
    assert set(kc.DDPM_GN_SITES) == set(kc.FLAGSHIP_GN_SITES)
    assert all(m_.eps == kc.DDPM_EPS for m_ in m.modules() if hasattr(m_, "eps"))
