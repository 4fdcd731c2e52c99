"""nshmc_tpu_torch's SpatialTransformer stack and the conditional and
class-conditional U-Nets against the JAX package: the same random weights
(numpy, from a seed, carried over by the port's inverse mappings) and the
same inputs through both, f32, at tests/test_unet.py's bar (atol 2e-4, rtol
1e-3). The port's LayerNorms take eps 1e-5 (the reference's), the JAX
block's 1e-6: at these unit-scale tokens that moves the outputs by ~5e-6
relative, inside the bar."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.models.ldm import transformer as jtr
from nshmc_tpu.models.unet import UNetConfig as JaxUNetConfig
from nshmc_tpu.models.unet import UNetModel as JaxUNetModel
from nshmc_tpu_torch.models.ldm import transformer as ttr
from nshmc_tpu_torch.models.port import state_dict_from_jax
from nshmc_tpu_torch.models.unet import UNetConfig, UNetModel
from test_torch_ldm import redraw
from test_torch_unet import TINY

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=1e-3)
C, HEADS, DH, CTX_DIM = 32, 4, 8, 24


def jax_spatial(context_dim, depth=2, seed=0):
    """(JAX SpatialTransformer, random params, the port's module with them)."""
    jm = jtr.SpatialTransformer(C, HEADS, DH, depth=depth, context_dim=context_dim)
    ctx = None if context_dim is None else jnp.zeros((1, 3, context_dim))
    params = redraw(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 4, 4, C)), context=ctx)), seed)
    tm = ttr.SpatialTransformer(C, HEADS, DH, depth=depth, context_dim=context_dim)
    sd = ttr.spatial_transformer_state_dict_from_jax(jax.tree.map(np.asarray, params))
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return jm, params, tm.eval()


def _arr(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (block, with a context): each of the five against its JAX counterpart
BLOCKS = [("GEGLU", False), ("FeedForward", False), ("CrossAttention", False),
          ("CrossAttention", True), ("BasicTransformerBlock", False),
          ("BasicTransformerBlock", True), ("SpatialTransformer", False),
          ("SpatialTransformer", True)]


@pytest.mark.parametrize("block,with_context", BLOCKS)
def test_block_matches_jax(block, with_context):
    jm, params, tm = jax_spatial(CTX_DIM if with_context else None)
    p = params["params"]
    inner = HEADS * DH
    ctx = _arr(2, (2, 5, CTX_DIM)) if with_context else None
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    if block == "SpatialTransformer":
        x = _arr(1, (2, 8, 8, C))
        ref = jm.apply(params, jnp.asarray(x), context=jctx)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        out = tm(xt, tctx).permute(0, 2, 3, 1)
    else:
        x = _arr(1, (2, 64, inner))
        blk, tblk = p["block_0"], tm.transformer_blocks[0]
        jmods = {
            "GEGLU": (jtr.GEGLU(4 * inner), blk["ff"]["in_proj"], tblk.ff.net[0]),
            "FeedForward": (jtr.FeedForward(inner), blk["ff"], tblk.ff),
            "CrossAttention": (jtr.CrossAttention(inner, CTX_DIM if with_context else None,
                                                  HEADS, DH), blk["attn2" if with_context
                                                                  else "attn1"],
                               tblk.attn2 if with_context else tblk.attn1),
            "BasicTransformerBlock": (jtr.BasicTransformerBlock(
                inner, HEADS, DH, CTX_DIM if with_context else None), blk, tblk)}
        jmod, jp, tmod = jmods[block]
        kw = {"context": jctx} if block in ("CrossAttention", "BasicTransformerBlock") else {}
        ref = jmod.apply({"params": jp}, jnp.asarray(x), **kw)
        out = tmod(torch.from_numpy(x), tctx) if kw else tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("context_dim", [None, CTX_DIM])
def test_round_trip_through_port_spatial_transformer(context_dim):
    """The port's state_dict through the JAX porter gives back the JAX
    params exactly; the port's keys are the reference layout."""
    _, params, tm = jax_spatial(context_dim, depth=2, seed=3)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = jtr.port_spatial_transformer(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree.map(np.asarray, params))
    for (path, a), b in zip(flat, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert "transformer_blocks.1.ff.net.0.proj.weight" in sd
    assert "transformer_blocks.0.attn1.to_out.0.bias" in sd
    assert "transformer_blocks.0.attn2.to_q.bias" not in sd


def jax_unet(seed=0, **changes):
    """(JAX U-Net, random params, port config) of tests/test_unet.py's TINY
    with `changes` (context_dim, transformer_depth, num_classes)."""
    jcfg = dataclasses.replace(JaxUNetConfig.from_model_yaml(**TINY), remat=False, **changes)
    jm = JaxUNetModel(jcfg)
    kw = {}
    if jcfg.context_dim is not None:
        kw["context"] = jnp.zeros((1, 5, jcfg.context_dim))
    if jcfg.num_classes is not None:
        kw["y"] = jnp.zeros((1,), jnp.int32)
    init = functools.partial(jm.init, **kw)
    params = redraw(jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                   jnp.zeros((1,))), seed)
    cfg = dataclasses.replace(UNetConfig.from_model_yaml(**TINY), **changes)
    tm = UNetModel(cfg)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), cfg), strict=True)
    return jm, params, tm.eval()


CASES = [dict(context_dim=CTX_DIM, transformer_depth=1),
         dict(context_dim=CTX_DIM, transformer_depth=2), dict(num_classes=10)]


@pytest.mark.parametrize("changes", CASES, ids=["context_depth1", "context_depth2", "classes"])
def test_conditional_unet_matches_jax(changes):
    """Forward and input gradient of the conditional U-Nets. The context
    has 5 tokens, the attention sites 64 and 16 queries, so a site that got
    no context (self-attention in place of cross-attention) would differ."""
    jm, params, tm = jax_unet(**changes)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.asarray([100.0, 500.0], np.float32)
    jkw, tkw = {}, {}
    if "context_dim" in changes:
        ctx = rng.standard_normal((2, 5, CTX_DIM)).astype(np.float32)
        jkw["context"], tkw["context"] = jnp.asarray(ctx), torch.from_numpy(ctx)
    else:
        y = np.asarray([3, 7])
        jkw["y"], tkw["y"] = jnp.asarray(y), torch.from_numpy(y)

    def jloss(xx):
        out = jm.apply(params, xx, jnp.asarray(t), **jkw)
        return jnp.sum(out[..., :3] ** 2), out

    ref_g, ref = jax.jit(jax.grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(t), **tkw)
    (g,) = torch.autograd.grad((out[..., :3] ** 2).sum(), xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), **TOL)
    if "context_dim" in changes:  # the context reaches the output
        out2 = tm(torch.from_numpy(x), torch.from_numpy(t), context=2 * tkw["context"])
        assert float((out2 - out.detach()).abs().max()) > 1e-4
        n_sites = sum(isinstance(m, ttr.SpatialTransformer) for m in tm.modules())
        assert n_sites == 4 and not any(type(m).__name__ == "AttentionBlock"
                                        for m in tm.modules())
    else:
        assert tm.label_emb.weight.dtype == torch.float32


def test_class_labels_required_exactly_when_conditional():
    _, _, tm = jax_unet(num_classes=10)
    x, t = torch.zeros(1, 16, 16, 3), torch.zeros(1)
    with pytest.raises(ValueError):
        tm(x, t)
    _, _, plain = jax_unet()
    with pytest.raises(ValueError):
        plain(x, t, y=torch.zeros(1, dtype=torch.long))


def test_conditional_latent_unet_sites():
    """configs/ffhq_latent.yaml's latent U-Net with a context (ch 224 cut to
    32 for the count): its GroupNorm32 calls are the SpatialTransformers'
    norms at kernel_check.COND_UNET_NORM_SITES, eps 1e-6, its GN+SiLU sites
    the latent U-Net's, and no AttentionBlock (K1) runs."""
    from nshmc_tpu_torch.models.ldm import latent_unet_config
    from nshmc_tpu_torch.scripts import kernel_check as kc

    cfg = dataclasses.replace(latent_unet_config(), model_channels=32, context_dim=512)
    unet = UNetModel(cfg).eval()
    ctx = torch.zeros((1, 1, 512))
    with torch.no_grad():
        gn_sites, attn_sites, norm_sites = kc.count_sites(
            unet, lambda: unet(torch.zeros((1, 64, 64, 3)), torch.full((1,), 500.0),
                               context=ctx))

    def scaled(sites):
        return {(8, r, 7 * c): n for (_, r, c), n in sites.items()}

    assert scaled(norm_sites) == kc.COND_UNET_NORM_SITES and not attn_sites
    assert scaled(gn_sites) == kc.LATENT_UNET_GN_SITES
    norms = [m.norm for m in unet.modules() if isinstance(m, ttr.SpatialTransformer)]
    assert len(norms) == 16 and all(n.eps == 1e-6 for n in norms)
