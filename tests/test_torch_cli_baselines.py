"""The iterative baselines through nshmc_tpu_torch's CLIs on the tiny
configs (CPU, f32) with a synthetic image: each pixel --algo (DPS with both
--noise values) and both latent ReSamples write {idx}.png, metrics.jsonl
and the summary line; ReSample's ladder reaches its hard consistency and the
original sampler both stages. The CLI computes the JAX CLI's y0 (the
loaded image through the operator, here at sigma_0 0 against the JAX
package's own loading and operator) and draws y0's noise and then x_T (1,
d, d, c) from the image's host generator, the step draws from its
engine generator."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.operators import build_operator as jax_build_operator
from nshmc_tpu.utils import images as jax_images
from nshmc_tpu_torch import cli
from nshmc_tpu_torch.sampling import loop
from _torch_algo_parity import count_branches
from test_torch_cli import _synthetic_dataset

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
CFG = os.path.join(HERE, "..", "configs", "tiny_test.yaml")
LATENT_CFG = os.path.join(HERE, "..", "configs", "tiny_latent_test.yaml")
PIXEL_RUNS = [(a, []) for a in cli.PIXEL_BASELINES] + [("dps", ["--noise", "ddim"])]


def _run(tmp_path, cfg, algo, *flags):
    data = _synthetic_dataset(tmp_path / "data")
    out = tmp_path / "out"
    summary = cli.main(["--config", cfg, "-i", str(out), "--data_path", str(data),
                        "--device", "cpu", "--no-bf16", "--algo", algo, *flags])
    return summary, out, data


def _check_artifacts(summary, out, algo, capsys):
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
    for name in ("0.png", "orig_0.png", "y0_0.png", "metrics.jsonl"):
        assert (out / name).exists(), name
    rec = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["algo"] == algo
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"summary": summary}


@pytest.mark.parametrize("algo,flags", PIXEL_RUNS,
                         ids=[a + "-".join([""] + f[1:]) for a, f in PIXEL_RUNS])
def test_pixel_baseline_cli_writes_png_and_summary(tmp_path, capsys, algo, flags):
    summary, out, _ = _run(tmp_path, CFG, algo, "--deg", "sr2", *flags)
    _check_artifacts(summary, out, algo, capsys)


@pytest.fixture
def branches(monkeypatch):
    return count_branches(monkeypatch)


@pytest.mark.parametrize("algo,steps,want", [
    ("resample", "5", {"hard_consistency": 1, "pixel": 0, "latent": 0}),  # t = 80 of 16 ... 96
    ("resample_original", "20", {"hard_consistency": 0, "pixel": 1, "latent": 1}),
])
def test_latent_resample_cli_writes_png_and_summary(tmp_path, capsys, branches, algo, steps,
                                                    want):
    summary, out, _ = _run(tmp_path, LATENT_CFG, algo, "--timesteps", steps)
    _check_artifacts(summary, out, algo, capsys)
    assert branches == want


@pytest.mark.parametrize("algo", ["dps", "resample"])
def test_cli_draws_and_y0_match_the_jax_cli(tmp_path, monkeypatch, algo):
    """y0 at sigma_0 0 is the JAX CLI's H(data_transform(load_image)); the
    sampler gets x_T of (1, d, d, c) drawn right after y0's noise from the
    host generator seeded seed + idx, and the engine generator."""
    seen = {}
    real = loop.iterative_sampling

    def spy(model_fn, schedule, seq, algo_, xt, y0, generator=None, draws=None):
        seen.update(xt=xt.clone(), y0=y0.clone(), generator=generator)
        return real(model_fn, schedule, seq, algo_, xt, y0, generator, draws)

    monkeypatch.setattr(loop, "iterative_sampling", spy)
    cfg = CFG if algo == "dps" else LATENT_CFG
    _, _, data = _run(tmp_path, cfg, algo, "--sigma_0", "0", "--seed", "9", "--deg", "sr2")
    d, zd = 16, 8
    side = d if algo == "dps" else zd
    assert seen["xt"].shape == (1, side, side, 3)
    host = torch.Generator().manual_seed(9)
    torch.randn(seen["y0"].shape, generator=host)  # y0's noise comes first
    assert torch.equal(seen["xt"], torch.randn((1, side, side, 3), generator=host))
    assert seen["generator"] is not None and seen["generator"].initial_seed() == 9
    x01 = jax_images.load_image(str(data / "img0.png"), d)
    jop = jax_build_operator("sr2", 3, d, np.random.default_rng(1234))
    want = jop.H_img(jax_images.data_transform(jnp.asarray(x01))[None])
    np.testing.assert_allclose(seen["y0"].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
