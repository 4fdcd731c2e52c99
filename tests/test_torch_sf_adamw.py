"""nshmc_tpu_torch.solvers.sf_adamw against nshmc_tpu.solvers.sf_adamw:
100 steps on a quadratic, with and without warmup and weight decay, on one
tensor and on a tuple of tensors; and solvers.adamw against optax.adamw, the
inner solve of both ReSamples. f32 throughout, iterates at rtol 1e-5 (a few
ulps of drift over 100 steps; atol 1e-6 for entries that pass near 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nshmc_tpu.solvers import sf_adamw as jsf
from nshmc_tpu_torch.solvers import adamw, sf_adamw

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _problem(seed=0, shapes=((2, 4, 4, 3),)):
    rng = np.random.default_rng(seed)
    targets = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    weights = [rng.uniform(0.5, 3.0, s).astype(np.float32) for s in shapes]
    x0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def grads(xs, lib):
        return [2 * lib(w) * (x - lib(t)) for x, t, w in zip(xs, targets, weights)]

    return x0, grads


@pytest.mark.parametrize("kw", [{}, {"warmup_steps": 10}, {"weight_decay": 0.05},
                                {"warmup_steps": 7, "weight_decay": 0.01, "r": 0.5}],
                         ids=["plain", "warmup", "decay", "warmup_decay_r"])
def test_sf_adamw_100_steps_match_jax(kw):
    x0, grads = _problem()
    jx, x = jnp.asarray(x0[0]), torch.from_numpy(x0[0])
    jst, st = jsf.sf_adamw_init(jx), sf_adamw.sf_adamw_init(x)
    jstep = jax.jit(lambda x, g, s: jsf.sf_adamw_step(x, g, s, lr=0.05, **kw))
    for _ in range(100):
        jx, jst = jstep(jx, grads([jx], jnp.asarray)[0], jst)
        x, st = sf_adamw.sf_adamw_step(x, grads([x], torch.from_numpy)[0], st, lr=0.05, **kw)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.z.numpy(), np.asarray(jst.z), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.exp_avg_sq.numpy(), np.asarray(jst.exp_avg_sq), rtol=RTOL)
    assert st.k.dtype == torch.int32 and int(st.k) == int(jst.k) == 100
    assert st.weight_sum.dtype == st.lr_max.dtype == torch.float32
    np.testing.assert_allclose(float(st.weight_sum), float(jst.weight_sum), rtol=RTOL)
    np.testing.assert_allclose(float(st.lr_max), float(jst.lr_max), rtol=RTOL)


def test_sf_adamw_on_a_tuple_of_tensors():
    """A dict of two leaves in JAX (its tree unzip takes a tuple of params
    for one of its 3-tuples), a tuple of two tensors here."""
    x0, grads = _problem(1, ((3, 5), (2, 2, 2)))
    jx, x = {"a": jnp.asarray(x0[0]), "b": jnp.asarray(x0[1])}, tuple(map(torch.from_numpy, x0))
    jst, st = jsf.sf_adamw_init(jx), sf_adamw.sf_adamw_init(x)
    for _ in range(100):
        jg = grads([jx["a"], jx["b"]], jnp.asarray)
        jx, jst = jsf.sf_adamw_step(jx, {"a": jg[0], "b": jg[1]}, jst, lr=0.05,
                                    warmup_steps=5, weight_decay=0.02)
        x, st = sf_adamw.sf_adamw_step(x, tuple(grads(x, torch.from_numpy)), st, lr=0.05,
                                       warmup_steps=5, weight_decay=0.02)
    assert isinstance(x, tuple) and isinstance(st.z, tuple) and len(x) == 2
    for a, b in zip(x + st.z, (jx["a"], jx["b"], jst.z["a"], jst.z["b"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_opt_matches_optax(weight_decay):
    """300 steps (the hard-consistency solve's count) of optax.adamw(5e-3)
    on a quadratic against adamw.adamw_opt."""
    x0, grads = _problem(2)
    w, t = (np.random.default_rng(2).uniform(0.5, 3.0, x0[0].shape).astype(np.float32),
            np.random.default_rng(3).uniform(-1, 1, x0[0].shape).astype(np.float32))
    opt = optax.adamw(5e-3, weight_decay=weight_decay)

    def jloss(x):
        return jnp.mean(jnp.asarray(w) * (x - jnp.asarray(t)) ** 2)

    def body(i, carry):
        x, st = carry
        u, st = opt.update(jax.grad(jloss)(x), st, x)
        return optax.apply_updates(x, u), st

    jx0 = jnp.asarray(x0[0])
    want = jax.jit(lambda x: jax.lax.fori_loop(0, 300, body, (x, opt.init(x)))[0])(jx0)
    got = adamw.adamw_opt(lambda x: torch.mean(torch.from_numpy(w) * (x - torch.from_numpy(t))
                                               ** 2),
                          torch.from_numpy(x0[0]), 300, 5e-3, weight_decay=weight_decay)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
