"""nshmc_tpu_torch's bkse KernelWizard (models/kernel_wizard.py) and the
nonlinear-blur operator (operators/nonlinear_blur.py) against the JAX
package on the CPU, at tests/test_kernel_wizard.py's small config (NF 8,
2 front / 3 back resblocks, kernel_dim 64, 256^2 so that the bottleneck is
2x2): the bkse key layout, the weight bridge both ways, adapt_kernel and
the kernel extractor, and H and its input gradient of both blur networks.
Tolerance of the networks: atol 2e-4, rtol 1e-3 (tests/test_unet.py's bar);
weights carried across exactly. One exception, stated: the f32 input
gradient of the bkse operator at 256^2 differs from jax.grad at isolated
elements (0.4% of them, up to 1.2e-3 max|ref|), where an activation sits
within rounding of a ReLU kink and the two packages take different sides;
there it is held to a relative L2 error of 1e-4, and the same gradient in
float64 is held to the networks' bar elementwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.models import kernel_wizard as jkw
from nshmc_tpu.operators import nonlinear_blur as jnb
from nshmc_tpu_torch.models import kernel_wizard as kw
from nshmc_tpu_torch.operators import nonlinear_blur as nb
from nshmc_tpu_torch import operators
from _torch_operator_parity import GRAD, NET_ATOL, NET_RTOL
from test_kernel_wizard import TKernelWizard, _small_cfg

torch.set_num_threads(2)


def _cfg():
    return kw.KernelWizardConfig(**dataclasses.asdict(_small_cfg()))


def _jax_params(seed=0):
    """Random JAX parameters of the whole wizard: the adapt_kernel path's
    and the kernel extractor's (flax folds the key by module path, so the
    shared feature extractor gets the same weights from both inits)."""
    cfg = _small_cfg()
    net, key, x = jkw.KernelWizard(cfg), jax.random.PRNGKey(seed), jnp.zeros((1, 256, 256, 3))
    adapt = net.init(key, x, jnp.zeros((1, 2, 2, cfg.kernel_dim)),
                     method=jkw.KernelWizard.adapt_kernel)["params"]
    extract = net.init(key, x, x)["params"]
    for name in set(adapt) & set(extract):
        for a, b in zip(jax.tree.leaves(adapt[name]), jax.tree.leaves(extract[name])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return {"params": {**extract, **adapt}}


def _port(params):
    model = kw.KernelWizard(_cfg()).eval()
    model.load_state_dict(kw.state_dict_from_jax(params, _cfg()), strict=True)
    return model


def _allclose(ours, ref, what):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=NET_ATOL,
                               rtol=NET_RTOL, err_msg=what)


def _nhwc(a):
    return np.transpose(np.asarray(a), (0, 2, 3, 1))


def test_state_dict_keys_are_the_bkse_keys():
    """The bkse mirror's checkpoint loads strictly, with no conversion, and
    the port then computes the mirror's adaptKernel."""
    torch.manual_seed(0)
    mirror = TKernelWizard().eval()
    model = kw.KernelWizard(_cfg()).eval()
    ours, theirs = model.state_dict(), mirror.state_dict()
    assert list(ours) == list(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    model.load_state_dict(theirs, strict=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 3, 256, 256)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 64, 2, 2)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model.adapt_kernel(x, k).numpy(),
                                   mirror.adaptKernel(x, k).numpy(), atol=1e-5)


def test_weight_bridge_round_trips_exactly():
    params = _jax_params(1)
    back = jkw.port_kernel_wizard(
        {k: v.numpy() for k, v in _port(params).state_dict().items()}, _small_cfg())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_adapt_kernel_and_its_input_gradient_match_jax():
    params = _jax_params(2)
    model = _port(params).requires_grad_(False)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 3, 256, 256)).astype(np.float32)
    k = (rng.normal(size=(2, 64, 2, 2)) * 1.2).astype(np.float32)
    net = jkw.KernelWizard(_small_cfg())
    fn = lambda v: net.apply(params, v, jnp.asarray(_nhwc(k)),
                             method=jkw.KernelWizard.adapt_kernel)
    out_j, vjp = jax.vjp(fn, jnp.asarray(_nhwc(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = model.adapt_kernel(xt, torch.from_numpy(k))
    _allclose(out_t, np.transpose(np.asarray(out_j), (0, 3, 1, 2)), "adapt_kernel")
    w = rng.standard_normal(x.shape).astype(np.float32)  # a cotangent
    (out_t * torch.from_numpy(w)).sum().backward()
    (g_j,) = vjp(jnp.asarray(_nhwc(w)))
    _allclose(xt.grad, np.transpose(np.asarray(g_j), (0, 3, 1, 2)), "input gradient")


def test_kernel_extractor_matches_jax():
    params = _jax_params(4)
    model = _port(params)
    rng = np.random.default_rng(5)
    xs, xb = (rng.uniform(0, 1, (1, 3, 256, 256)).astype(np.float32) for _ in range(2))
    mu_j, logvar_j = jkw.KernelWizard(_small_cfg()).apply(params, jnp.asarray(_nhwc(xs)),
                                                          jnp.asarray(_nhwc(xb)))
    with torch.no_grad():
        mu, logvar = model(torch.from_numpy(xs), torch.from_numpy(xb))
    _allclose(mu, np.transpose(np.asarray(mu_j), (0, 3, 1, 2)), "kernel code")
    assert mu.shape == (1, 64, 2, 2) and not logvar.abs().max() and not np.abs(logvar_j).max()


def _blur_pair(net, d):
    if net == "bkse":
        ref = jnb.NonlinearBlur.create_bkse(channels=3, img_dim=d, seed=3,
                                            wizard_cfg=_small_cfg())
    else:
        ref = jnb.NonlinearBlur.create(channels=3, img_dim=d, seed=3)
    params = jax.tree.map(np.asarray, ref.blur_params)
    ours = nb.NonlinearBlur.from_jax(np.asarray(ref.kernel_code), params, 3, d, nf=ref._nf,
                                     net=ref._net, wizard_cfg=_cfg(), device="cpu")
    return ours, ref


@pytest.mark.parametrize("net,d", [("surrogate", 16), ("surrogate", 32), ("bkse", 256)])
def test_nonlinear_blur_h_and_gradient_match_jax(net, d):
    ours, ref = _blur_pair(net, d)
    assert not ours.is_linear() and ours.bkse == (net == "bkse")
    rng = np.random.default_rng(d)
    x = rng.uniform(-1, 1, (2, 3 * d * d)).astype(np.float32)
    y = rng.uniform(-1, 1, x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ours.H(xt)
    _allclose(out, ref.H(jnp.asarray(x)), "H")
    ((torch.from_numpy(y) - out) ** 2).sum().backward()
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum((jnp.asarray(y) - ref.H(v)) ** 2))(
        jnp.asarray(x)))
    if net == "bkse":  # kinks at rounding distance: see the module docstring
        rel = np.linalg.norm(xt.grad.numpy() - g_ref) / np.linalg.norm(g_ref)
        assert rel <= GRAD, rel
    else:
        _allclose(xt.grad, g_ref, "input gradient")
    np.testing.assert_array_equal(ours.H_pinv(torch.from_numpy(y)).numpy(), y)
    assert not any(p.requires_grad for p in ours.net.parameters())


def test_bkse_input_gradient_in_float64():
    """adapt_kernel's input gradient, the bkse operator's network, in
    float64 in both packages: no rounding puts an activation on the other
    side of a kink, and the gradients agree elementwise."""
    ours, ref = _blur_pair("bkse", 256)
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (2, 3, 256, 256))
    w = rng.standard_normal(x.shape)
    k = np.broadcast_to(np.asarray(ref.kernel_code, np.float64), (2, 2, 2, 64))
    net = ours.net.double()
    xt = torch.from_numpy(x).requires_grad_(True)
    (net.adapt_kernel(xt, torch.from_numpy(np.transpose(k, (0, 3, 1, 2)).copy()))
     * torch.from_numpy(w)).sum().backward()
    with jax.enable_x64():
        params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), ref.blur_params)
        model = jkw.KernelWizard(ref._wizard_cfg, dtype=jnp.float64)
        _, vjp = jax.vjp(lambda v: model.apply(params, v, jnp.asarray(k),
                                               method=jkw.KernelWizard.adapt_kernel),
                         jnp.asarray(_nhwc(x)))
        (g_ref,) = vjp(jnp.asarray(_nhwc(w)))
        assert g_ref.dtype == jnp.float64
    _allclose(xt.grad, np.transpose(np.asarray(g_ref), (0, 3, 1, 2)), "float64 gradient")


def test_port_draws_its_own_operator_from_a_seed():
    """build_operator's deblur_nonlinear: the kernel code randn * 1.2 and the
    surrogate from a torch generator seeded 0; the same seed, the same H."""
    a = operators.build_operator("deblur_nonlinear", 3, 16, device="cpu")
    b = nb.NonlinearBlur.create(3, 16, seed=0, device="cpu")
    assert a.kernel_code.shape == (1, 2, 2, 512) and 0.9 < float(a.kernel_code.std()) < 1.5
    x = torch.from_numpy(np.random.default_rng(0).uniform(-0.9, 0.9, (2, 768))
                         .astype(np.float32))
    np.testing.assert_array_equal(a.H(x).numpy(), b.H(x).numpy())
    # the last conv starts near 0 (N(0, 1e-3^2)), as the JAX surrogate's: H ~ the identity
    assert float((a.H(x) - x).abs().max()) < 0.05
    c = nb.NonlinearBlur.create(3, 16, seed=1, device="cpu")
    assert not torch.equal(c.kernel_code, a.kernel_code)


def test_create_bkse_loads_a_checkpoint_strictly():
    torch.manual_seed(1)
    sd = TKernelWizard().state_dict()
    op = nb.NonlinearBlur.create_bkse(sd, 3, 256, wizard_cfg=_cfg(), device="cpu")
    assert op.bkse and torch.equal(op.net.state_dict()["conv_last.bias"], sd["conv_last.bias"])
    with pytest.raises(RuntimeError):
        nb.NonlinearBlur.create_bkse({**sd, "bogus.weight": torch.zeros(1)}, 3, 256,
                                     wizard_cfg=_cfg(), device="cpu")
    rand = nb.NonlinearBlur.create_bkse(None, 3, 256, wizard_cfg=_cfg(), device="cpu")
    x = torch.zeros(1, 3 * 256 * 256)
    assert torch.isfinite(rand.H(x)).all()
