"""nshmc_tpu_torch ADM U-Net against the JAX U-Net: the same random weights
(made with numpy from a seed, carried over by state_dict_from_jax) and the
same inputs through both, on the TINY config of tests/test_unet.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.models.port import adm_param_mapping as jax_param_mapping
from nshmc_tpu.models.port import port_adm_state_dict
from nshmc_tpu.models.unet import UNetConfig as JaxUNetConfig
from nshmc_tpu.models.unet import UNetModel as JaxUNetModel
from nshmc_tpu_torch.models.port import state_dict_from_jax
from nshmc_tpu_torch.models.unet import UNetConfig, UNetModel

torch.set_num_threads(2)

TINY = dict(
    image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
    learn_sigma=True, class_cond=False, attention_resolutions="8", num_heads=2,
    num_head_channels=16, num_heads_upsample=-1, use_scale_shift_norm=True,
    dropout=0.0, resblock_updown=True,
)
SETTINGS = [(True, True), (False, False)]  # (use_scale_shift_norm, resblock_updown)


def jax_tiny(scale_shift=True, updown=True, seed=0):
    """(JAX model, its params with every leaf random, port config). The
    JAX init zeroes the output convs, so every leaf is redrawn with numpy
    (lecun-normal kernels, GN scales near 1, small biases) to make each
    layer matter."""
    kw = dict(TINY, use_scale_shift_norm=scale_shift, resblock_updown=updown)
    jcfg = dataclasses.replace(JaxUNetConfig.from_model_yaml(**kw), remat=False)
    jmodel = JaxUNetModel(jcfg)
    # every leaf is redrawn below, so only the shapes of the init are needed
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            std = 0.1
        draw = rng.standard_normal(leaf.shape).astype(np.float32) * std
        return jnp.asarray(draw + (1.0 if name == "scale" else 0.0))

    params = jax.tree_util.tree_map_with_path(redraw, params)
    return jmodel, params, UNetConfig.from_model_yaml(**kw)


def torch_tiny(params, cfg, dtype=torch.float32, **cfg_changes):
    cfg = dataclasses.replace(cfg, **cfg_changes)
    model = UNetModel(cfg, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), cfg),
                          strict=True)
    return model.eval()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    return x, np.asarray([100.0, 500.0], np.float32)


def test_config_from_yaml_ffhq():
    cfg = UNetConfig.from_model_yaml(
        image_size=256, num_channels=128, num_res_blocks=1, channel_mult="",
        learn_sigma=True, attention_resolutions=16, num_heads=4,
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True)
    jcfg = JaxUNetConfig.from_model_yaml(
        image_size=256, num_channels=128, num_res_blocks=1, channel_mult="",
        learn_sigma=True, attention_resolutions=16, num_heads=4,
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True)
    for f in dataclasses.fields(cfg):
        if f.name != "remat":
            # a field the JAX config lacks (SD 2's linear projections) stays at its default
            want = getattr(jcfg, f.name) if hasattr(jcfg, f.name) else f.default
            assert getattr(cfg, f.name) == want, f.name
    assert cfg.channel_mult == (1, 1, 2, 2, 4, 4) and cfg.attention_ds == (16,)


@pytest.mark.parametrize("scale_shift,updown", SETTINGS)
def test_state_dict_keys_are_reference_keys(scale_shift, updown):
    """The port's parameter names are the reference checkpoint keys that
    the JAX package's mapping enumerates, with the checkpoint's shapes."""
    _, params, cfg = jax_tiny(scale_shift, updown)
    sd = UNetModel(cfg).state_dict()
    jcfg = JaxUNetConfig.from_model_yaml(
        **dict(TINY, use_scale_shift_norm=scale_shift, resblock_updown=updown))
    prefixes = {p for p, _ in jax_param_mapping(jcfg).values()}
    assert set(sd) == {f"{p}.{n}" for p in prefixes for n in ("weight", "bias")}
    ported = state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert {k: tuple(v.shape) for k, v in ported.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert sd["middle_block.1.qkv.weight"].dim() == 3  # 1x1 Conv1d (O, I, 1)


@pytest.mark.parametrize("scale_shift,updown", SETTINGS)
def test_forward_parity(scale_shift, updown):
    jmodel, params, cfg = jax_tiny(scale_shift, updown)
    x, t = _inputs()
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t)))
    out = torch_tiny(params, cfg)(torch.from_numpy(x), torch.from_numpy(t))
    assert out.shape == (2, 16, 16, 6) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("scale_shift,updown", SETTINGS)
def test_input_gradient_parity(scale_shift, updown):
    jmodel, params, cfg = jax_tiny(scale_shift, updown)
    x, t = _inputs(1)
    ref = jax.grad(lambda x: jnp.sum(
        jmodel.apply(params, x, jnp.asarray(t))[..., :3] ** 2))(jnp.asarray(x))
    model = torch_tiny(params, cfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad((model(xt, torch.from_numpy(t))[..., :3] ** 2).sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)
    assert all(not p.requires_grad for p in model.parameters())  # frozen prior


@pytest.mark.parametrize("scale_shift,updown", SETTINGS)
def test_remat_on_off_equal(scale_shift, updown):
    """remat='big' (checkpoint units at >= remat_min_res) changes memory,
    not numbers: forward and input gradient are bitwise equal."""
    _, params, cfg = jax_tiny(scale_shift, updown)
    x, t = _inputs(2)
    results = []
    for remat in ("big", "none"):
        model = torch_tiny(params, cfg, remat=remat, remat_min_res=8)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = model(xt, torch.from_numpy(t))
        (g,) = torch.autograd.grad((out ** 2).sum(), xt)
        results.append((out.detach().numpy(), g.numpy()))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])


@pytest.mark.parametrize("scale_shift,updown", SETTINGS)
def test_bf16_close_to_f32(scale_shift, updown):
    _, params, cfg = jax_tiny(scale_shift, updown)
    x, t = _inputs(3)
    out32 = torch_tiny(params, cfg)(torch.from_numpy(x), torch.from_numpy(t))
    model16 = torch_tiny(params, cfg, dtype=torch.bfloat16)
    assert model16.input_blocks[0][0].weight.dtype == torch.bfloat16
    assert model16.out[0].weight.dtype == torch.float32  # fp32 GN island
    out16 = model16(torch.from_numpy(x), torch.from_numpy(t))
    assert out16.dtype == torch.float32
    np.testing.assert_allclose(out16.detach().numpy(), out32.detach().numpy(),
                               atol=0.1, rtol=0.1)


@pytest.mark.parametrize("scale_shift,updown", SETTINGS)
def test_state_dict_round_trip(scale_shift, updown):
    """port state_dict -> the JAX package's own porter reproduces the JAX
    params exactly."""
    _, params, cfg = jax_tiny(scale_shift, updown)
    sd = torch_tiny(params, cfg).state_dict()
    jcfg = JaxUNetConfig.from_model_yaml(
        **dict(TINY, use_scale_shift_norm=scale_shift, resblock_updown=updown))
    back = port_adm_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))
