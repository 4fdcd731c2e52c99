"""How far the bf16 input gradient lies from the f32 one, in each package.

The flagship configuration (configs/ffhq.yaml's ADM U-Net at 256^2, random
weights drawn with numpy from a seed, the same in both packages), one
chain, the pixel loss ||y0 - H(decode(x))||^2 through the 3-step DDIM
decoder with 92% random inpainting: its input gradient in bf16 (bf16
torso, fp32 GroupNorm islands) and in f32, with every layer drawn at
lecun-normal scale ("all_random") or with the layers the reference
zero-initialises (ResBlock out_conv, attention proj_out, the final conv)
at 0.05 of it, near the residual identity, as chip_smoke.py draws them
("small_out"), through the JAX package and
through nshmc_tpu_torch, all on the CPU (XLA's CPU backend for JAX, not a
TPU). Prints each package's relative L2 distance ||g_bf16 - g_f32|| /
||g_f32||, and holds the two packages' f32 gradients to each other.

Slow (minutes on a CPU): run with
    python -m pytest tests/test_torch_bf16_gradient_gap.py -m slow -s
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nshmc_tpu.hmc import engine as jeng
from nshmc_tpu.models.unet import UNetConfig as JaxUNetConfig
from nshmc_tpu.models.unet import UNetModel as JaxUNetModel
from nshmc_tpu.operators import build_operator as jax_build_operator
from nshmc_tpu.sampling.ddim import make_decoder as jax_make_decoder
from nshmc_tpu.schedules import DDIMSequence as JaxSeq
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch.hmc import engine
from nshmc_tpu_torch.models.port import state_dict_from_jax
from nshmc_tpu_torch.models.unet import UNetConfig, UNetModel
from nshmc_tpu_torch.operators import build_operator
from nshmc_tpu_torch.sampling.ddim import make_decoder
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from test_torch_ldm import redraw

pytestmark = pytest.mark.slow
torch.set_num_threads(4)

D = 256
CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "ffhq.yaml")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _small_out(path, leaf):
    names = [getattr(k, "key", "") for k in path]
    zero_init = names[-2] in ("out_conv", "proj_out") and names[-1] == "kernel"
    return leaf * 0.05 if zero_init else leaf


@pytest.mark.parametrize("recipe", ["all_random", "small_out"])
def test_bf16_gradient_gap_port_against_jax(recipe):
    with open(CFG) as f:
        model_yaml = yaml.safe_load(f)["model"]
    jcfg = JaxUNetConfig.from_model_yaml(**model_yaml)
    params = redraw(jax.eval_shape(JaxUNetModel(jcfg).init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, D, D, 3)), jnp.zeros((1,))), 0)
    if recipe == "small_out":
        params = jax.tree_util.tree_map_with_path(_small_out, params)
    cfg = UNetConfig.from_model_yaml(**model_yaml)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    rng = np.random.default_rng(1)
    x_orig = rng.uniform(-1, 1, (1, D, D, 3)).astype(np.float32)
    x = rng.standard_normal((D, D, 3)).astype(np.float32)
    jop = jax_build_operator("inpaint_random", 3, D, np.random.default_rng(0))
    op = build_operator("inpaint_random", 3, D, np.random.default_rng(0), device="cpu")
    y0 = np.array(jop.H_img(jnp.asarray(x_orig)))[0]

    grads = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = JaxUNetModel(jcfg, dtype=jdt)
        jdecode = jax_make_decoder(lambda xx, t, jm=jm: jm.apply(params, xx, t),
                                   JaxSched.create(), JaxSeq.create(1000, 3))
        jloss = jeng.make_pixel_loss_fn(jdecode, jop, jnp.asarray(y0))
        grads[("jax", name)] = np.asarray(jax.jit(jax.grad(lambda xx: jloss(xx)[0]))(
            jnp.asarray(x)), np.float32)
        model = UNetModel(cfg, dtype=tdt)
        model.load_state_dict(sd, strict=True)
        decode = make_decoder(model.eval(), DiffusionSchedule.create(device="cpu"),
                              DDIMSequence.create(1000, 3))
        loss = engine.make_pixel_loss_fn(decode, op, torch.from_numpy(y0))
        grads[("port", name)] = engine.value_and_grad(
            loss, torch.from_numpy(x)[None])[2][0].numpy()
        del jm, model

    gap = {pkg: _rel(grads[(pkg, "bf16")], grads[(pkg, "f32")]) for pkg in ("jax", "port")}
    f32_parity = _rel(grads[("port", "f32")], grads[("jax", "f32")])
    print(f"\nbf16 vs f32 input gradient, {recipe} weights, relative L2 (flagship, 1 chain, "
          f"CPU; JAX on XLA's "
          f"CPU backend): JAX {gap['jax']:.4f}, port {gap['port']:.4f}, port / JAX "
          f"{gap['port'] / gap['jax']:.2f}; port f32 vs JAX f32 {f32_parity:.2e}; bf16 port vs "
          f"JAX {_rel(grads[('port', 'bf16')], grads[('jax', 'bf16')]):.4f}")
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in grads.values())
    assert f32_parity < 1e-3  # the same function in f32 (tests/test_torch_hmc.py: 2e-4 tiny)
