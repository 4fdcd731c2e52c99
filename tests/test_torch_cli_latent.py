"""nshmc_tpu_torch's latent CLI (`--algo hmc_latent`) end to end on the tiny
latent config (CPU, f32), with a synthetic image in place of the absent
dataset; its extract_kept_samples against the JAX package's; and --mesh,
not ported yet, with the latent algorithms."""
import json
import os

import numpy as np
import pytest
import torch

from nshmc_tpu.cli_latent import extract_kept_samples as jax_extract_kept_samples
from nshmc_tpu_torch import cli
from nshmc_tpu_torch.cli_latent import extract_kept_samples
from test_torch_cli import _synthetic_dataset

torch.set_num_threads(2)

CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_latent_test.yaml")
RUNS = {  # flags -> (samples decoded, whether a std-dev map is written)
    # 1 anneal attempt, 4 post-anneal: chains keep samples in their rings
    "kept": (["--latent_epochs", "1", "--latent_sampling", "2", "--sigma_y", "60",
              "--sigma_0", "10"], True),
    # no post-anneal attempts: the final chain states are decoded instead
    "final_state": (["--latent_epochs", "2", "--latent_sampling", "0"], True),
    # the eps-net differentiated too
    "full_grad": (["--latent_epochs", "1", "--latent_sampling", "1", "--latent_full_grad"],
                  None),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cli_hmc_latent_runs_and_writes_artifacts(tmp_path, capsys, run):
    flags, std_map = RUNS[run]
    data = _synthetic_dataset(tmp_path / "data")
    out = tmp_path / "out"
    summary = cli.main([
        "--config", CFG, "-i", str(out), "--data_path", str(data), "--device", "cpu",
        "--no-bf16", "--algo", "hmc_latent", "--deg", "inpaint_random", "--chains", "2",
        "--tau", "0.1", "--epsilon", "0.05", "--verbose", *flags])
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
    names = ["0.png", "orig_0.png", "y0_0.png", "metrics.jsonl"]
    for name in names + (["std_dev_map_0.png"] if std_map else []):
        assert (out / name).exists(), name
    rec = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["algo"] == "hmc_latent" and rec["deg"] == "inpaint_random"
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == {"summary": summary}
    attempts = [line for line in printed if line.strip().startswith("attempt ")]
    assert len(attempts) == {"kept": 5, "final_state": 2, "full_grad": 3}[run]
    if run == "kept":  # the run reached the post-anneal accepts it is meant to
        assert "psnr_std" in summary and "accepted 0 " not in attempts[-1]


def test_extract_kept_samples_matches_jax():
    rng = np.random.default_rng(0)
    rings = rng.standard_normal((4, 3, 2, 2, 1)).astype(np.float32)
    for kept in ([0, 1, 3, 5], [0, 0, 0, 0], [2, 0, 7, 1]):
        kept = np.asarray(kept)
        np.testing.assert_array_equal(extract_kept_samples(rings, kept),
                                      np.asarray(jax_extract_kept_samples(rings, kept)))
    assert extract_kept_samples(rings, np.zeros(4)).shape == (0, 2, 2, 1)


@pytest.mark.parametrize("algo", ["resample", "resample_original"])
def test_cli_unported_latent_algos_raise(tmp_path, algo):
    """Both ReSamples are ported (tests/test_torch_cli_baselines.py); what
    stays unported with them, --mesh > 1, raises before any output."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 2"):
        cli.main(["--config", CFG, "-i", str(tmp_path / "o"), "--device", "cpu",
                  "--algo", algo, "--mesh", "2"])
    assert not (tmp_path / "o").exists()


def test_cli_latent_refuses_to_fall_back_to_cpu(tmp_path):
    """Without --device cpu, a host without CUDA gets an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", CFG, "--algo", "hmc_latent", "-i", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
