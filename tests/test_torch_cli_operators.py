"""nshmc_tpu_torch's CLIs with the ported degradations, end to end on the
tiny configs (CPU, f32): the pixel path with sr4, phase_retrieval,
deblur_nonlinear and cs2, the latent path with sr4. Each run writes its
artifacts and the summary line."""
import json
import os

import numpy as np
import pytest
import torch

from nshmc_tpu_torch import cli
from test_torch_cli import _synthetic_dataset

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
RUNS = {
    "hmc": ("tiny_test.yaml", ["--hmc_epochs", "1", "--hmc_sampling", "1"]),
    "hmc_latent": ("tiny_latent_test.yaml", ["--latent_epochs", "1", "--latent_sampling", "1"]),
}


@pytest.mark.parametrize("algo,deg", [("hmc", "sr4"), ("hmc", "phase_retrieval"),
                                      ("hmc", "deblur_nonlinear"), ("hmc", "cs2"),
                                      ("hmc_latent", "sr4")])
def test_cli_runs_with_degradation(tmp_path, capsys, algo, deg):
    cfg, flags = RUNS[algo]
    data = _synthetic_dataset(tmp_path / "data")
    out = tmp_path / "out"
    summary = cli.main([
        "--config", os.path.join(CONFIGS, cfg), "-i", str(out), "--data_path", str(data),
        "--device", "cpu", "--no-bf16", "--algo", algo, "--deg", deg, "--chains", "2",
        "--tau", "0.1", "--epsilon", "0.05", *flags])
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
    for name in ("0.png", "orig_0.png", "y0_0.png", "metrics.jsonl"):
        assert (out / name).exists(), name
    rec = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["algo"] == algo and rec["deg"] == deg
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"summary": summary}
