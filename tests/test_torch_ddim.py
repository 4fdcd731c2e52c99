"""nshmc_tpu_torch DDIM decode against nshmc_tpu.sampling.ddim on the tiny
U-Net: the same weights and the same x_T, f32, value and input gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nshmc_tpu.sampling.ddim import ddim_decode as jax_ddim_decode
from nshmc_tpu.schedules import DDIMSequence as JaxSeq
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch.sampling.ddim import ddim_decode, ddim_step
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from test_torch_unet import jax_tiny, torch_tiny

torch.set_num_threads(2)


def _setup(seed=0):
    jmodel, params, cfg = jax_tiny(seed=seed)
    model = torch_tiny(params, cfg)
    x = np.random.default_rng(seed + 10).standard_normal((2, 16, 16, 3)).astype(np.float32)
    return jmodel, params, model, x


def test_ddim_decode_value_and_grad_match_jax():
    jmodel, params, model, x = _setup()
    jfn = lambda xx, t: jmodel.apply(params, xx, t)
    jsched, jseq = JaxSched.create(), JaxSeq.create(1000, 3)

    def jloss(xx):
        out = jax_ddim_decode(jfn, jsched, jseq, xx)
        return jnp.sum(out ** 2), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    sched, seq = DiffusionSchedule.create(device="cpu"), DDIMSequence.create(1000, 3)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ddim_decode(model, sched, seq, xt)
    (g,) = torch.autograd.grad((out ** 2).sum(), xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-4, rtol=1e-3)
    # The gradient passes back through three U-Nets and the 1/sqrt(alpha_bar)
    # (~5 at t=750) step factors, which amplify float32 summation-order
    # differences; no clip boundary lies within them (the nearest pre-clip
    # value is 1.6e-4 from +-1). Measured: relative L2 error 4.3e-5.
    g, jg = g.numpy(), np.asarray(jg)
    assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 2e-4
    np.testing.assert_allclose(g, jg, rtol=1e-3, atol=2e-3 * np.abs(jg).max())
    assert np.abs(out.detach().numpy()).max() <= 1.0  # the final x0 is clipped


def test_ddim_step_terminal_alpha_is_one():
    """The last step (t_next = -1) returns x0 itself: alpha_bar(-1) = 1."""
    _, _, model, x = _setup(1)
    sched = DiffusionSchedule.create(device="cpu")
    with torch.no_grad():
        xt_next, x0 = ddim_step(model, sched, torch.from_numpy(x), 250, -1)
    np.testing.assert_allclose(xt_next.numpy(), x0.numpy(), atol=1e-6)
