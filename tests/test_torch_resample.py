"""ReSample (algos/resample.py, through sampling/loop.py) and the original
ReSample sampler (sampling/resample_original.py) of nshmc_tpu_torch against
the JAX package's, whole trajectories with the JAX key chain's draws
replayed: with the analytic toy model and an analytic decoder at the full
inner counts (the 300-step hard-consistency solve; 50 pixel and 25 latent
steps), and on the tiny LDM of tests/test_resample.py (configs/
tiny_latent_test.yaml's widths, random JAX params carried across) at reduced
inner counts, each latent U-Net call held too. Each test counts the
branches it reached: ReSample's hard consistency (t % 20 == 0, t <= 200)
once on each ladder, the original sampler's pixel and latent stages once
each (20 DDIM steps: index 10 and index 5). Then the helpers. Bars in
tests/_torch_algo_parity.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.algos.resample import ReSample as JaxReSample
from nshmc_tpu.sampling import resample_original as jro
from nshmc_tpu.sampling.loop import iterative_sampling as jax_loop
from nshmc_tpu.schedules import DDIMSequence as JaxSeq
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch.algos import resample
from nshmc_tpu_torch.sampling import resample_original as ro
from nshmc_tpu_torch.sampling.loop import iterative_sampling
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from _torch_algo_draws import algo_draws, resample_original_draws
from _torch_algo_parity import (NET_TOL, TOY_TOL, Recorder, assert_close, count_branches,
                                jax_toy, problem, tiny_ldm, toy)

torch.set_num_threads(2)


# the analytic decoder: nonlinear, but led by its linear term. The original
# sampler's pred_x0 is not clipped and reaches |x| ~ 100 at t = 951, where a
# saturated tanh's derivative 1 - tanh^2 is all cancellation: XLA's and
# torch's tanh, a few ulps apart there, then differ by 1% in the gradient.
def jax_decode(z):
    return 0.2 * z + 0.05 * jnp.tanh(z)


def decode(z):
    return 0.2 * z + 0.05 * torch.tanh(z)


@pytest.fixture
def counts(monkeypatch):
    """Counts of the branches the port took."""
    return count_branches(monkeypatch)


def run_resample(jmodel, model, jdec, dec, sched, jsched, seq_args, y0, z, key, **kw):
    jop, op = kw.pop("ops")
    jalgo = JaxReSample(operator=jop, sigma_0=0.1, decode_fn=jdec, **kw)
    algo = resample.ReSample(operator=op, sigma_0=0.1, decode_fn=dec, **kw)
    want = jax.jit(lambda z: jax_loop(jmodel, jsched, JaxSeq.create(*seq_args), jalgo, z,
                                      jnp.asarray(y0), key))(jnp.asarray(z))
    seq = DDIMSequence.create(*seq_args)
    got = iterative_sampling(model, sched, seq, algo, torch.from_numpy(z), torch.from_numpy(y0),
                             draws=algo_draws(algo, key, seq.n_steps, z.shape))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("noise", ["ddpm", "ddim"])
def test_resample_toy_trajectory_matches_jax(counts, noise):
    """11 steps 990 ... 90: the hard consistency (300 AdamW steps) at t = 180."""
    jop, op, y0, z = problem("sr2", batch=1, seed=1)
    got, want = run_resample(jax_toy, toy, jax_decode, decode, DiffusionSchedule.create(
        device="cpu"), JaxSched.create(), (1000, 10), y0, z, jax.random.PRNGKey(5),
        ops=(jop, op), noise=noise)
    assert counts["hard_consistency"] == 1
    assert [t for t in DDIMSequence.create(1000, 10).seq if resample.resamples_at(t)] == [180]
    assert_close(got, want, TOY_TOL, f"ReSample {noise}")


def run_original(jmodel, model, jdec, dec, jenc, enc, sched, jsched, y0, z, key, cfg_kw,
                 ops, travel=False):
    jop, op = ops
    jcfg, cfg = jro.ResampleOriginalConfig(**cfg_kw), ro.ResampleOriginalConfig(**cfg_kw)
    total = len(ro.make_ddim_timesteps(cfg.ddim_steps, sched.num_timesteps))
    tn = (np.random.default_rng(9).standard_normal((total, *z.shape)).astype(np.float32)
          if travel else None)
    want = jax.jit(lambda z: jro.resample_original_sample(
        lambda x, t: jax.lax.stop_gradient(jmodel(x, t)), jsched, jdec, jenc, jop,
        jnp.asarray(y0), z, key, jcfg, travel_noise=tn))(jnp.asarray(z))
    got = ro.resample_original_sample(
        model, sched, dec, enc, op, torch.from_numpy(y0), torch.from_numpy(z), cfg,
        draws=resample_original_draws(key, total, z.shape),
        travel_noise=None if tn is None else torch.from_numpy(tn))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("travel", [False, True], ids=["drawn", "travel_noise"])
def test_resample_original_toy_trajectory_matches_jax(counts, travel):
    """20 DDIM steps on the 1000-step schedule, 50 pixel and 25 latent AdamW
    steps: a pixel stage at index 10, a latent one at index 5 and the final
    latent solve; the travel draws from the key chain, or given."""
    jop, op, y0, z = problem("inpaint_random", batch=1, seed=2)
    got, want = run_original(jax_toy, toy, jax_decode, decode, lambda x: 0.5 * x,
                             lambda x: 0.5 * x, DiffusionSchedule.create(device="cpu"),
                             JaxSched.create(), y0, z, jax.random.PRNGKey(6),
                             dict(ddim_steps=20), (jop, op), travel)
    assert (counts["pixel"], counts["latent"]) == (1, 1)
    assert_close(got, want, TOY_TOL, "original ReSample")


@pytest.fixture(scope="module")
def ldm():
    jmodel, jdec, jenc, port = tiny_ldm()
    return jmodel, jdec, jenc, port, JaxSched.create("quad", 0.0015, 0.0195, 100)


def test_resample_tiny_ldm_matches_jax(ldm, counts):
    """6 steps 96 ... 16 of the 100-step schedule through the eps-net
    (differentiated) and the VQ decoder; the hard consistency (5 steps) at
    t = 80 adds one eps call."""
    jmodel, jdec, _, port, jsched = ldm
    jop, op, y0, _ = problem("sr2", batch=1, seed=3)
    z = np.random.default_rng(4).standard_normal((1, 8, 8, 3)).astype(np.float32)
    rec = Recorder(port.model_fn(stop_gradient=False))
    got, want = run_resample(jmodel, rec, jdec, port.decode_first_stage, port.schedule, jsched,
                             (100, 5), y0, z, jax.random.PRNGKey(7), ops=(jop, op),
                             inner_steps=5)
    assert counts["hard_consistency"] == 1
    rec.assert_calls_match(jmodel, 6 + 1)
    assert_close(got, want, NET_TOL, "ReSample, tiny LDM")


def test_resample_original_tiny_ldm_matches_jax(ldm, counts):
    """20 DDIM steps (index 10 pixel, index 5 latent), 3 AdamW steps each
    solve, through the stop-grad eps-net, the VQ decoder and its encoder."""
    jmodel, jdec, jenc, port, jsched = ldm
    jop, op, y0, _ = problem("inpaint_random", batch=1, seed=5)
    z = np.random.default_rng(6).standard_normal((1, 8, 8, 3)).astype(np.float32)
    rec = Recorder(port.model_fn(stop_gradient=True))
    got, want = run_original(jmodel, rec, jdec, port.decode_first_stage, jenc,
                             port.encode_first_stage, port.schedule, jsched, y0, z,
                             jax.random.PRNGKey(8),
                             dict(ddim_steps=20, pixel_opt_iters=3, latent_opt_iters=3),
                             (jop, op))
    assert (counts["pixel"], counts["latent"]) == (1, 1)
    rec.assert_calls_match(jmodel, 20)
    assert_close(got, want, NET_TOL, "original ReSample, tiny LDM")


@pytest.mark.parametrize("num_ddim,num_ddpm", [(20, 100), (10, 1000), (500, 1000), (7, 100)])
def test_ddim_timesteps_and_alphas_match_jax(num_ddim, num_ddpm):
    ts = ro.make_ddim_timesteps(num_ddim, num_ddpm)
    np.testing.assert_array_equal(ts, jro.make_ddim_timesteps(num_ddim, num_ddpm))
    assert ts[0] == 1  # the +1 shift
    for eta in (0.0, 0.5):
        got = ro.make_ddim_alphas(DiffusionSchedule.create("quad", 0.0015, 0.0195, num_ddpm,
                                                           device="cpu"), ts, eta)
        want = jro.make_ddim_alphas(JaxSched.create("quad", 0.0015, 0.0195, num_ddpm), ts, eta)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))


def test_stochastic_resample_and_stages_match_jax():
    rng = np.random.default_rng(10)
    x0, xt, noise = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32) for _ in range(3))
    a_t, sigma = np.float32(0.37), np.float32(2.5)
    want = jro.stochastic_resample(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(a_t),
                                   jnp.asarray(sigma), jnp.asarray(noise))
    got = ro.stochastic_resample(*map(torch.from_numpy, (x0, xt)), torch.tensor(a_t),
                                 torch.tensor(sigma), torch.from_numpy(noise))
    assert_close(got.numpy(), want, TOY_TOL, "stochastic_resample")
    cfg = ro.ResampleOriginalConfig(ddim_steps=20)
    stages = {i: ro.travel_stage(i, 20, cfg) for i in range(20)}
    assert {i: s for i, s in stages.items() if s} == {10: "pixel", 5: "latent"}
    assert not any(ro.travel_stage(i, 17, cfg) == "latent" for i in range(17))  # < 18 steps
