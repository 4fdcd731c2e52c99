"""The port's CLIs with the noise-space flags of tests/test_cli.py, on the
tiny configs (CPU, f32, a 1-step DDIM ladder to keep them short, synthetic
images): --image_batch, --save_epochs --diagnostics, --adapt da, --algo
hmc_cond, dmplug_adam and dmplug_lbfgs, --checkpoint-dir run twice (pixel
and latent), every command line of scripts/run_fullbudget.sh parsed, and
--mesh > 1 in one process raising with the launcher's name."""
import json
import os
import re
import shlex

import numpy as np
import pytest
import torch
from PIL import Image

from nshmc_tpu_torch import cli
from nshmc_tpu_torch.solvers import dmplug
from test_torch_cli import _synthetic_dataset

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
CFG = os.path.join(HERE, "..", "configs", "tiny_test.yaml")
LATENT_CFG = os.path.join(HERE, "..", "configs", "tiny_latent_test.yaml")
SHORT = ["--no-bf16", "--device", "cpu", "--timesteps", "1", "--tau", "0.1", "--epsilon",
         "0.05", "--hmc_epochs", "1", "--hmc_sampling", "1", "--chains", "2"]


@pytest.fixture
def data(tmp_path):
    return str(_synthetic_dataset(tmp_path / "data", n=2))


def _run(out, data, *args, cfg=CFG):
    return cli.main(["--config", cfg, "-i", str(out), "--data_path", data, *SHORT, *args])


def _metrics(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_image_batch_equals_each_image_alone(tmp_path, data):
    """--image_batch 2: both images in one batch of 4 chains, each with the
    result it has alone (its own generators)."""
    summary = _run(tmp_path / "b", data, "--subset_end", "2", "--image_batch", "2")
    _run(tmp_path / "a", data, "--subset_end", "2")
    assert np.isfinite(summary["psnr"])
    for f in ("0.png", "1.png", "orig_1.png", "y0_1.png"):
        assert (tmp_path / "b" / f).exists(), f
    batched, alone = _metrics(tmp_path / "b"), _metrics(tmp_path / "a")
    assert [r["idx"] for r in batched] == [0, 1]
    for b, a in zip(batched, alone):
        assert b["psnr"] == pytest.approx(a["psnr"], rel=1e-6)
        assert b["ssim"] == pytest.approx(a["ssim"], rel=1e-6, abs=1e-7)


def test_save_epochs_and_diagnostics(tmp_path, data, capsys):
    out = tmp_path / "o"
    summary = _run(out, data, "--save_epochs", "--diagnostics", "--hmc_sampling", "4")
    assert np.isfinite(summary["psnr"])
    assert list(out.glob("hmc_*.png")), "no per-accept epoch images"
    trail = json.loads((out / "hmc_trail_0.json").read_text())
    assert len(trail["psnr"]) == len(trail["sigma_y"]) == len(trail["epoch"]) >= 1
    assert trail["epoch"] == sorted(set(trail["epoch"]))
    diag = json.loads((out / "diagnostics_0.json").read_text())
    assert diag["n_chains"] == 2 and diag["n_draws"] == 4
    assert "diagnostics:" in capsys.readouterr().out


def test_adapt_da_prints_the_dual_averaged_step(tmp_path, data, capsys):
    summary = _run(tmp_path / "o", data, "--adapt", "da", "--driver", "jit")
    assert np.isfinite(summary["psnr"])
    assert re.search(r"dual-averaged eps: [0-9.]+ \(\d+ rounds\)", capsys.readouterr().out)


def test_adapt_da_yields_to_the_observed_driver(tmp_path, data, capsys):
    _run(tmp_path / "o", data, "--adapt", "da", "--verbose")
    printed = capsys.readouterr().out
    assert "--adapt da ignored" in printed and "dual-averaged" not in printed


def test_hmc_cond(tmp_path, data):
    out = tmp_path / "o"
    summary = _run(out, data, "--algo", "hmc_cond")
    assert np.isfinite(summary["psnr"])
    assert (out / "std_dev_map_0.png").exists()  # 2 chains x 3 sample slots


@pytest.mark.parametrize("algo", ["dmplug_adam", "dmplug_lbfgs"])
def test_dmplug(tmp_path, data, monkeypatch, algo):
    """A patched budget: Adam 5 steps, L-BFGS 1 x 3."""
    adam = dmplug.dmplug_adam
    monkeypatch.setattr(dmplug, "dmplug_adam", lambda loss, x0, cfg=None, **kw: adam(
        loss, x0, dmplug.DMPlugAdamConfig(max_steps=5), **kw))
    summary = _run(tmp_path / "o", data, "--algo", algo, "--lbfgs_epochs", "1",
                   "--lbfgs_inner", "3")
    assert np.isfinite(summary["psnr"]) and "psnr_std" not in summary  # one image out
    assert _metrics(tmp_path / "o")[0]["algo"] == algo


@pytest.mark.parametrize("cfg", ["pixel", "latent"])
def test_checkpoint_dir_run_twice(tmp_path, data, cfg):
    """The second run restores each image's final snapshot (img{idx}) and
    writes the same image."""
    extra = (["--algo", "hmc", "--chain_chunk", "1", "--attempts_per_round", "2"]
             if cfg == "pixel" else
             ["--algo", "hmc_latent", "--latent_epochs", "2", "--latent_sampling", "1",
              "--chain_chunk", "1", "--save_epochs"])
    conf = CFG if cfg == "pixel" else LATENT_CFG
    ck = tmp_path / "ck"
    first = _run(tmp_path / "a", data, "--checkpoint-dir", str(ck), *extra, cfg=conf)
    assert (ck / "img0" / "step_0.pt").exists()
    stamp = os.path.getmtime(ck / "img0" / "step_0.pt")
    second = _run(tmp_path / "b", data, "--checkpoint-dir", str(ck), *extra, cfg=conf)
    assert first == second
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a" / "0.png")),
                          np.asarray(Image.open(tmp_path / "b" / "0.png")))
    assert os.path.getmtime(ck / "img0" / "step_0.pt") >= stamp


def _fullbudget_command_lines():
    with open(os.path.join(HERE, "..", "scripts", "run_fullbudget.sh")) as f:
        text = f.read().replace("\\\n", " ")
    lines = [line.split("python -m nshmc_tpu.cli", 1)[1] for line in text.splitlines()
             if "python -m nshmc_tpu.cli" in line]
    return [shlex.split(line.replace('"$APR"', "7")) for line in lines]


def test_fullbudget_command_lines_parse():
    lines = _fullbudget_command_lines()
    assert len(lines) == 2
    for argv in lines:
        opt = cli.get_parser().parse_args(argv)
        assert opt.attempts_per_round == 7 and opt.checkpoint_dir


def test_parser_takes_every_jax_flag_but_noise():
    """Every flag of nshmc_tpu/cli.py's parser, --noise too since the
    baselines are ported, with the JAX CLI's defaults, choices and types;
    --device is the port's."""
    from nshmc_tpu.cli import get_parser as jax_parser

    jax, port = jax_parser(), cli.get_parser()
    assert set(jax._option_string_actions) - set(port._option_string_actions) == set()
    assert set(port._option_string_actions) - set(jax._option_string_actions) == {"--device"}
    jactions = {a.dest: a for a in jax._actions}
    for a in port._actions:
        if a.dest in jactions:
            j = jactions[a.dest]
            assert (a.default, a.choices, a.type) == (j.default, j.choices, j.type), a.dest


def test_mesh_raises_with_its_pointer(tmp_path, monkeypatch):
    """--mesh > 1 with hmc or hmc_latent shards the chains over --mesh
    processes, one a device: in one process it raises before any output,
    naming the launcher and the NSHMC_* contract; over a mesh the chains
    must split evenly."""
    from nshmc_tpu_torch.parallel import multihost as mh

    for cfg, algo in ((CFG, "hmc"), (LATENT_CFG, "hmc_latent")):
        with pytest.raises(ValueError, match="NSHMC_DIST=1 torchrun --nproc_per_node 2 -m "
                                             "nshmc_tpu_torch.cli --mesh 2"):
            cli.main(["--config", cfg, "-i", str(tmp_path / "o"), "--device", "cpu", "--algo",
                      algo, "--mesh", "2"])
        assert not (tmp_path / "o").exists()
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="--chains 3 is not a multiple of --mesh 2"):
        cli.main(["--config", CFG, "-i", str(tmp_path / "o"), "--device", "cpu", "--mesh", "2",
                  "--chains", "3"])
    assert not (tmp_path / "o").exists()
