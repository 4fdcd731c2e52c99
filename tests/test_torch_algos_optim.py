"""The optimization-in-the-loop baselines of nshmc_tpu_torch, DiffPIR (50
schedule-free-AdamW steps a DDIM step) and DAPS (the order-5 ODE and 100
Langevin steps, run_daps), against the JAX package's, whole trajectories
with the JAX key chain's draws replayed: with the analytic toy model at
the full inner counts over the operator branches (DAPS's two Langevin
losses: sigma_0 0 with a linear operator, else the proximal one), and
through the tiny U-Net at reduced inner counts, each U-Net call held too.
Bars in tests/_torch_algo_parity.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import algos as jalgos
from nshmc_tpu.sampling.loop import iterative_sampling as jax_loop
from nshmc_tpu.schedules import DDIMSequence as JaxSeq
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch import algos
from nshmc_tpu_torch.sampling.loop import iterative_sampling
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from _torch_algo_draws import algo_draws, daps_draws
from _torch_algo_parity import (FFT_TOL, NET_TOL, TOY_TOL, Recorder, assert_close, jax_toy,
                                problem, toy)
from test_torch_unet import jax_tiny, torch_tiny

torch.set_num_threads(2)

STEPS = 3
SCHED = DiffusionSchedule.create(device="cpu")


def run_both(name, deg, sigma_0, jmodel, model, batch=2, seed=0, **changes):
    """The JAX sampler (iterative_sampling, or run_daps) and the port's on
    one problem and one key; `changes` replace the algorithm's fields."""
    jop, op, y0, x_t = problem(deg, batch, seed)
    key = jax.random.PRNGKey(seed + 11)
    jalgo = jalgos.build_algo(name, jop, sigma_0, deg).replace(**changes)
    algo = dataclasses.replace(algos.build_algo(name, op, sigma_0, deg), **changes)
    jseq, seq = JaxSeq.create(1000, STEPS), DDIMSequence.create(1000, STEPS)
    ja = (jnp.asarray(y0), key)
    if name == "daps":
        want = jax.jit(lambda x: jalgos.run_daps(jmodel, JaxSched.create(), jseq, jalgo, x,
                                                 *ja))(jnp.asarray(x_t))
        got = algos.run_daps(model, SCHED, seq, algo, torch.from_numpy(x_t),
                             torch.from_numpy(y0),
                             draws=daps_draws(key, STEPS, x_t.shape, algo.langevin_steps))
    else:
        want = jax.jit(lambda x: jax_loop(jmodel, JaxSched.create(), jseq, jalgo, x,
                                          *ja))(jnp.asarray(x_t))
        got = iterative_sampling(model, SCHED, seq, algo, torch.from_numpy(x_t),
                                 torch.from_numpy(y0),
                                 draws=algo_draws(algo, key, STEPS, x_t.shape))
    return got.numpy(), np.asarray(want)


TOY_CASES = [
    ("diffpir", "inpaint_random", 0.1),
    ("diffpir", "sr2", 0.0),
    ("diffpir", "denoise", 0.1),
    ("daps", "inpaint_random", 0.0),    # linear, noiseless: the data-only Langevin loss
    ("daps", "sr2", 0.1),               # the proximal loss
    ("daps", "phase_retrieval", 0.0),   # nonlinear: the proximal loss at sigma_0 0
]


@pytest.mark.parametrize("name,deg,sigma_0", TOY_CASES,
                         ids=["-".join(map(str, c)) for c in TOY_CASES])
def test_toy_trajectory_matches_jax(name, deg, sigma_0):
    got, want = run_both(name, deg, sigma_0, jax_toy, toy)
    tol = FFT_TOL if deg == "phase_retrieval" else TOY_TOL
    assert_close(got, want, tol, f"{name} {deg} sigma_0 {sigma_0}")


def test_daps_ode_subdivision():
    """The order-5 ODE from t runs at t and at the multiples of t // 4
    below t but above 0 (Python ints, so 748 right under 750), one eps call
    each, as the JAX package unrolls it; from t < 4, one call at t."""
    calls, jcalls = [], []
    algo, jalgo = algos.DAPS(operator=None), jalgos.DAPS(operator=None)
    x = torch.zeros(1, 2, 2, 3)
    for t, want in ((750, [750, 748, 561, 374, 187]), (3, [3])):
        calls.clear()
        jcalls.clear()
        algo.ode(lambda x_, t_: calls.append(float(t_[0])) or toy(x_, t_), SCHED, x, t)
        jalgo.ode(lambda x_, t_: jcalls.append(float(t_[0])) or jax_toy(x_, t_),
                  JaxSched.create(), jnp.zeros((1, 2, 2, 3)), t)
        assert calls == jcalls == want


@pytest.fixture(scope="module")
def tiny_unet():
    jmodel, params, cfg = jax_tiny(seed=5)
    return jax.jit(lambda x, t: jmodel.apply(params, x, t)), torch_tiny(params, cfg)


@pytest.mark.parametrize("name,changes,calls", [
    ("diffpir", {"inner_steps": 5}, STEPS),
    ("daps", {"langevin_steps": 5, "order": 2}, STEPS),  # one ODE step a DDIM step
], ids=["diffpir", "daps"])
def test_tiny_unet_trajectory_matches_jax(tiny_unet, name, changes, calls):
    jmodel, model = tiny_unet
    rec = Recorder(model)
    got, want = run_both(name, "inpaint_random", 0.1, jmodel, rec, batch=1, seed=6, **changes)
    rec.assert_calls_match(jmodel, calls)
    assert_close(got, want, NET_TOL, name)
