"""Shared pieces of the baseline algorithms' parity tests: the analytic toy
eps-model of tests/test_algos.py in both packages, a degradation problem
built alike in both, the tiny U-Net and the tiny LDM carried across from
random JAX params, and a recorder of the port's network calls.

Bars, stated once:
  - a whole trajectory with the toy model: max |port - JAX| <= TOY_TOL *
    max |JAX|. Both sides are f32 on the CPU; measured 6e-8 to 7.2e-7
    relative over every algorithm and operator branch, so 1e-5 leaves 14x
    for the order of f32 sums (inner solves of 50-300 steps included);
    through phase retrieval's FFTs FFT_TOL, the bar of the FFT operators'
    gradients in tests/_torch_operator_parity.py (two FFT libraries; DAPS's
    300 Langevin steps measured at 1.3e-5);
  - each network call of a trajectory: the port's output on the port's
    input against the JAX network's on the same input at tests/test_unet.py's
    bar (atol 2e-4, rtol 1e-3);
  - a whole trajectory through the tiny U-Net or the tiny LDM: max |port -
    JAX| <= NET_TOL * max |JAX|. Each call's 2e-4 error, carried through 3-6
    steps (and a division by sqrt(loss) in DPS): 1.4e-5 to 1.3e-4 relative
    measured, so 1e-3, 7x over the worst."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nshmc_tpu.models.ldm import autoencoder as jae
from nshmc_tpu.operators import build_operator as jax_build_operator
from nshmc_tpu_torch.models.ldm import LatentDiffusion
from nshmc_tpu_torch.operators import build_operator
from nshmc_tpu_torch.schedules import DiffusionSchedule

TOY_TOL = 1e-5
FFT_TOL = 1e-4
NET_TOL = 1e-3
CALL_ATOL, CALL_RTOL = 2e-4, 1e-3
D, C = 16, 3


def jax_toy(x, t):
    base = jnp.tanh(x * 0.3) * (1.0 + 1e-4 * t[:, None, None, None])
    return jnp.concatenate([base, jnp.zeros_like(base)], axis=-1)


def toy(x, t):
    base = torch.tanh(x * 0.3) * (1.0 + 1e-4 * t[:, None, None, None])
    return torch.cat([base, torch.zeros_like(base)], dim=-1)


def problem(deg, batch=2, seed=0, size=D):
    """(JAX operator, port operator, y0 (B, d_y) numpy, x_T numpy): the same
    degradation from the same numpy draws in both packages, y0 = H(x_orig)."""
    rng = np.random.default_rng(seed)
    x_orig = rng.uniform(-1, 1, (batch, size, size, C)).astype(np.float32)
    x_t = rng.standard_normal((batch, size, size, C)).astype(np.float32)
    jop = jax_build_operator(deg, C, size, np.random.default_rng(seed + 1))
    op = build_operator(deg, C, size, np.random.default_rng(seed + 1), device="cpu")
    return jop, op, np.array(jop.H_img(jnp.asarray(x_orig))), x_t


def assert_close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(want).all(), what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max |port - JAX| {err:.3e} > {tol} x {scale:.3e}"


class Recorder:
    """Wraps the port's eps-network and keeps each call's (x, t, output)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, x, t):
        out = self.fn(x, t)
        self.calls.append((x.detach().clone(), t.detach().clone(), out.detach().clone()))
        return out

    def assert_calls_match(self, jax_fn, n_calls):
        """Each recorded call against the JAX network (a jitted function,
        compiled once for its module's tests) on the same input."""
        assert len(self.calls) == n_calls, (len(self.calls), n_calls)
        for x, t, out in self.calls:
            want = np.asarray(jax_fn(jnp.asarray(x.numpy()), jnp.asarray(t.numpy())))
            np.testing.assert_allclose(out.numpy(), want, atol=CALL_ATOL, rtol=CALL_RTOL)


def tiny_ldm(t_steps=100):
    """The tiny latent stack of configs/tiny_latent_test.yaml with random JAX
    params in both packages: (JAX eps-net fn, JAX decode, JAX encode, port
    LatentDiffusion on the CPU)."""
    from test_torch_ldm import jax_latent_unet, jax_vq, port_ae, port_unet

    jm_u, uparams, ucfg = jax_latent_unet(0)
    jm_a, aparams, acfg = jax_vq(seed=1)
    ldm = LatentDiffusion(ucfg, acfg, DiffusionSchedule.create("quad", 0.0015, 0.0195, t_steps,
                                                               device="cpu"))
    ldm.unet.load_state_dict(port_unet(uparams, ucfg).state_dict())
    ldm.first_stage.load_state_dict(port_ae(type(ldm.first_stage), aparams, acfg).state_dict())
    return (jax.jit(lambda z, t: jm_u.apply(uparams, z, t)),
            lambda z: jm_a.apply(aparams, z, method=jae.VQModel.decode),
            lambda x: jm_a.apply(aparams, x, method=jae.VQModel.encode),
            ldm)


def count_branches(monkeypatch):
    """Count, from now to the test's end, the branches the port's ReSamples
    take: hard-consistency solves and the original sampler's pixel and
    latent stages. Returns the live counts."""
    from nshmc_tpu_torch.algos import resample
    from nshmc_tpu_torch.sampling import resample_original

    seen = {"hard_consistency": 0, "pixel": 0, "latent": 0}
    hard, stage = resample.ReSample._hard_consistency, resample_original.travel_stage

    def counting_hard(self, *args):
        seen["hard_consistency"] += 1
        return hard(self, *args)

    def counting_stage(*args):
        out = stage(*args)
        if out:
            seen[out] += 1
        return out

    monkeypatch.setattr(resample.ReSample, "_hard_consistency", counting_hard)
    monkeypatch.setattr(resample_original, "travel_stage", counting_stage)
    return seen
