"""The spectral and guided baselines of nshmc_tpu_torch (DDNM, DDRM, DPS,
PiGDM, DMPS, RED-diff; algos/base.py and sampling/loop.py under them)
against the JAX package's, whole trajectories with the JAX key chain's
draws replayed (tests/_torch_algo_draws.py): with the analytic toy model
over each operator branch (inpainting, SR, denoising; sigma_0 0 and 0.1;
DPS's ddpm and ddim steps), and through the tiny U-Net of
configs/tiny_test.yaml with every U-Net call held too. Bars in
tests/_torch_algo_parity.py. Then the unit checks: ddrm_init_x, get_pred_x,
build_algo's tables, RED-diff's carried state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import algos as jalgos
from nshmc_tpu.algos.spectral import ddrm_init_x as jax_ddrm_init_x
from nshmc_tpu.sampling.loop import iterative_sampling as jax_loop
from nshmc_tpu.schedules import DDIMSequence as JaxSeq
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch import algos
from nshmc_tpu_torch.algos.spectral import ddrm_init_x
from nshmc_tpu_torch.sampling.ddim import ddim_decode
from nshmc_tpu_torch.sampling.loop import iterative_sampling
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from _torch_algo_draws import algo_draws
from _torch_algo_parity import (NET_TOL, TOY_TOL, Recorder, assert_close, jax_toy, problem,
                                toy)
from test_torch_unet import jax_tiny, torch_tiny

torch.set_num_threads(2)

STEPS = 3  # the 750 -> 500 -> 250 -> x0 ladder
SCHED = DiffusionSchedule.create(device="cpu")


def run_both(name, deg, sigma_0, jmodel, model, noise="ddpm", batch=2, seed=0):
    """The JAX iterative_sampling and the port's on one problem and one key."""
    jop, op, y0, x_t = problem(deg, batch, seed)
    key = jax.random.PRNGKey(seed + 7)
    jalgo = jalgos.build_algo(name, jop, sigma_0, deg, noise=noise)
    algo = algos.build_algo(name, op, sigma_0, deg, noise=noise)
    want = jax.jit(lambda x: jax_loop(jmodel, JaxSched.create(), JaxSeq.create(1000, STEPS),
                                      jalgo, x, jnp.asarray(y0), key))(jnp.asarray(x_t))
    got = iterative_sampling(model, SCHED, DDIMSequence.create(1000, STEPS), algo,
                             torch.from_numpy(x_t), torch.from_numpy(y0),
                             draws=algo_draws(algo, key, STEPS, x_t.shape))
    return got.numpy(), np.asarray(want)


TOY_CASES = [
    ("ddnm", "inpaint_random", 0.0, "ddpm"),   # noiseless pseudo-inverse step
    ("ddnm", "inpaint_random", 0.1, "ddpm"),   # noisy, zero singulars in the V basis
    ("ddnm", "sr2", 0.1, "ddpm"),
    ("ddrm", "inpaint_random", 0.1, "ddpm"),
    ("ddrm", "sr4", 0.1, "ddpm"),
    ("ddrm", "denoise", 0.0, "ddpm"),
    ("dps", "inpaint_random", 0.1, "ddpm"),
    ("dps", "sr2", 0.1, "ddim"),
    ("dps", "denoise", 0.0, "ddpm"),
    ("pigdm", "inpaint_random", 0.0, "ddpm"),  # noiseless: the pseudo-inverse loss
    ("pigdm", "sr2", 0.1, "ddpm"),             # (HH^T + s^2)^-1 loss
    ("dmps", "inpaint_random", 0.1, "ddpm"),
    ("dmps", "denoise", 0.0, "ddpm"),
    ("reddiff", "inpaint_random", 0.1, "ddpm"),
    ("reddiff", "sr2", 0.0, "ddpm"),
    ("unconditional", "inpaint_random", 0.1, "ddpm"),
]


@pytest.mark.parametrize("name,deg,sigma_0,noise", TOY_CASES,
                         ids=["-".join(map(str, c)) for c in TOY_CASES])
def test_toy_trajectory_matches_jax(name, deg, sigma_0, noise):
    got, want = run_both(name, deg, sigma_0, jax_toy, toy, noise)
    assert_close(got, want, TOY_TOL, f"{name} {deg} sigma_0 {sigma_0} {noise}")


def test_unconditional_is_the_ddim_ladder():
    _, op, y0, x_t = problem("inpaint_random")
    seq = DDIMSequence.create(1000, STEPS)
    out = iterative_sampling(toy, SCHED, seq, algos.Unconditional(operator=op),
                             torch.from_numpy(x_t), torch.from_numpy(y0))
    torch.testing.assert_close(out, ddim_decode(toy, SCHED, seq, torch.from_numpy(x_t)),
                               atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def tiny_unet():
    jmodel, params, cfg = jax_tiny(seed=3)
    return jax.jit(lambda x, t: jmodel.apply(params, x, t)), torch_tiny(params, cfg)


@pytest.mark.parametrize("name", ["ddnm", "ddrm", "dps", "pigdm", "dmps", "reddiff"])
def test_tiny_unet_trajectory_matches_jax(tiny_unet, name):
    """One image, 92% random inpainting, sigma_0 0.1, through the tiny U-Net:
    each of its 3 calls and the whole trajectory."""
    jmodel, model = tiny_unet
    rec = Recorder(model)
    got, want = run_both(name, "inpaint_random", 0.1, jmodel, rec, batch=1, seed=4)
    rec.assert_calls_match(jmodel, STEPS)
    assert_close(got, want, NET_TOL, name)


def test_ddrm_init_x_matches_jax():
    jop, op, y0, _ = problem("sr4")
    key = jax.random.PRNGKey(0)
    at_t = 0.3
    want = jax_ddrm_init_x(key, jop, jnp.asarray(y0), 0.1, jnp.float32(at_t), (2, 16, 16, 3))
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, (2, 16 * 16 * 3))))
    got = ddrm_init_x(noise, op, torch.from_numpy(y0), 0.1, torch.tensor(at_t), (2, 16, 16, 3))
    assert_close(got.numpy(), want, TOY_TOL, "ddrm_init_x")


@pytest.mark.parametrize("name", ["ddnm", "ddrm"])
@pytest.mark.parametrize("sigma_0", [0.0, 0.1])
def test_get_pred_x_matches_jax(name, sigma_0):
    jop, op, y0, x_t = problem("sr2", seed=5)
    gt = np.tanh(x_t)
    at_next = SCHED.alpha_bar(250)
    jalgo = jalgos.build_algo(name, jop, sigma_0)
    algo = algos.build_algo(name, op, sigma_0)
    jargs = (jnp.asarray(gt), jnp.asarray(y0), jnp.float32(float(at_next)))
    want = (jalgo.get_pred_x(*jargs, jax.random.PRNGKey(0)) if name == "ddnm"
            else jalgo.get_pred_x(*jargs))
    got = algo.get_pred_x(torch.from_numpy(gt), torch.from_numpy(y0), at_next)
    assert_close(got.numpy(), want, TOY_TOL, name)
    if sigma_0 == 0:
        np.testing.assert_array_equal(got.numpy(), gt)


@pytest.mark.parametrize("name,deg,dataset", [
    ("dps", "phase_retrieval", "ffhq"), ("dps", "sr4", "ffhq"),
    ("reddiff", "deblur_aniso", "ffhq"), ("reddiff", "sr4", "ffhq"),
    ("reddiff", "inpaint_box", "ffhq"), ("reddiff", "inp_box", "celeba"),
    ("reddiff", "sr_bicubic4", "celeba"), ("reddiff", "hdr", "celeba"),
    ("daps", "phase_retrieval", "ffhq"), ("daps", "sr4", "ffhq"),
    ("diffpir", "sr4", "ffhq"), ("hmc", "sr4", "ffhq"),
])
def test_build_algo_matches_jax_tables(name, deg, dataset):
    """The per-task tables, first match winning (celeba's "inp_box" before
    "inp"), and DAPS's nonlinear flag from the operator."""
    jop = problem(deg)[0] if name == "daps" else None
    op = problem(deg)[1] if name == "daps" else None
    j = jalgos.build_algo(name, jop, 0.1, deg, dataset=dataset)
    p = algos.build_algo(name, op, 0.1, deg, dataset=dataset)
    assert type(p).__name__ == type(j).__name__
    for field in ("lam", "eta", "nonlinear", "sigma_0", "noise"):
        assert getattr(p, field, None) == getattr(j, field, None), field


def test_build_algo_and_dps_reject_unknown_names():
    with pytest.raises(NotImplementedError):
        algos.build_algo("resample", None, 0.1)
    with pytest.raises(ValueError, match="noise"):
        algos.build_algo("dps", None, 0.1, noise="ddim2")


def test_reddiff_state_threads_like_jax():
    """The first step starts from x0 itself; the carried x0_t_last is the
    updated x0 (equal to the JAX state after one step)."""
    jop, op, y0, x_t = problem("inpaint_random")
    at, at_next = SCHED.alpha_bar(750), SCHED.alpha_bar(500)
    jalgo, algo = jalgos.REDdiff(operator=jop, eta=0.5), algos.REDdiff(operator=op, eta=0.5)
    key = jax.random.PRNGKey(2)
    s0 = algo.init_state(torch.from_numpy(x_t))
    assert s0[1] is False
    _, _, (jx0, jinit) = jalgo.cal_x0(jax_toy, jnp.asarray(x_t), jalgo.init_state(x_t), 750,
                                      jnp.float32(float(at)), jnp.float32(float(at_next)),
                                      jnp.asarray(y0), key)
    x0, _, (x0_last, init) = algo.cal_x0(
        toy, torch.from_numpy(x_t), s0, 750, at, at_next, torch.from_numpy(y0),
        (torch.from_numpy(np.asarray(jax.random.normal(key, x_t.shape))),))
    assert init is True and bool(jinit)
    assert x0_last is x0
    assert_close(x0.numpy(), jx0, TOY_TOL, "RED-diff x0")
