"""nshmc_tpu_torch CLI end to end on the tiny config (CPU, f32), with a
synthetic image in place of the absent dataset, and the port's PSNR/SSIM
against nshmc_tpu.utils.metrics."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nshmc_tpu.utils import metrics as jax_metrics
from nshmc_tpu_torch import cli
from nshmc_tpu_torch.utils import images, metrics

torch.set_num_threads(2)

CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_test.yaml")
LATENT_CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_latent_test.yaml")


def _synthetic_dataset(root, size=16, n=1):
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        yy, xx = np.mgrid[:size, :size] / size
        img = np.stack([yy, xx, 0.5 + 0.3 * np.sin(6 * xx * yy)], -1)
        img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(root / f"img{i}.png")
    return root


def test_cli_hmc_runs_and_writes_artifacts(tmp_path, capsys):
    data = _synthetic_dataset(tmp_path / "data")
    out = tmp_path / "out"
    summary = cli.main([
        "--config", CFG, "-i", str(out), "--data_path", str(data), "--device", "cpu",
        "--no-bf16", "--algo", "hmc", "--deg", "inpaint_random", "--tau", "0.1",
        "--epsilon", "0.05", "--hmc_epochs", "2", "--hmc_sampling", "2",
    ])
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
    assert "psnr_std" in summary  # a multi-sample stack tracks the spread
    for name in ("0.png", "orig_0.png", "y0_0.png", "std_dev_map_0.png", "metrics.jsonl"):
        assert (out / name).exists(), name
    rec = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["algo"] == "hmc" and rec["deg"] == "inpaint_random"
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"summary": summary}


@pytest.mark.parametrize("flag", [["--algo", "ddnm", "--mesh", "2"], ["--mesh", "2"],
                                  ["--algo", "dps", "--mesh", "2"], ["--algo", "daps_x"],
                                  ["--algo", "diffpir", "--mesh", "4"],
                                  ["--algo", "reddiff", "--mesh", "2"],
                                  ["--algo", "resample", "--mesh", "2"]])
def test_cli_unported_flags_raise(tmp_path, flag):
    """A name that is no algorithm raises before any output, and so does
    --mesh > 1 with hmc in one process (its chains are sharded over --mesh
    processes, one a device: the message names the launcher). A baseline
    ignores --mesh in one process, as the JAX CLI does: its run equals the
    run without --mesh."""
    algo = flag[flag.index("--algo") + 1] if "--algo" in flag else "hmc"
    out = tmp_path / "o"
    if algo in ("hmc", "daps_x"):
        err, match = ((ValueError, "NSHMC_DIST=1 torchrun --nproc_per_node 2") if algo == "hmc"
                      else (NotImplementedError, "ROADMAP"))
        with pytest.raises(err, match=match):
            cli.main(["--config", CFG, "-i", str(out), "--device", "cpu", *flag])
        assert not out.exists()
        return
    data = _synthetic_dataset(tmp_path / "data")
    argv = ["--config", LATENT_CFG if algo == "resample" else CFG, "--data_path", str(data),
            "--device", "cpu", "--no-bf16", "--timesteps", "1", *flag]
    with_mesh = cli.main([*argv, "-i", str(tmp_path / "mesh")])
    assert with_mesh == cli.main([*argv, "--mesh", "0", "-i", str(out)])
    assert (tmp_path / "mesh" / "0.png").exists()


def test_psnr_ssim_match_jax_metrics():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_metrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_metrics.ssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)


def test_running_stats_and_transforms_match_jax():
    ours, ref = metrics.RunningStats(), jax_metrics.RunningStats()
    for vals in ({"psnr": [20.0, 22.0], "ssim": [0.5, 0.7]}, {"psnr": [25.0], "ssim": [0.9]}):
        ours.update(vals)
        ref.update(vals)
    assert ours.summary() == ref.summary()
    x = torch.linspace(-1.5, 1.5, 7)
    np.testing.assert_array_equal(images.inverse_data_transform(x).numpy(),
                                  np.clip((x.numpy() + 1) / 2, 0, 1))


def test_image_io_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    images.save_image(torch.from_numpy(img), str(tmp_path / "a.png"))
    back = images.load_image(str(tmp_path / "a.png"), 16)
    np.testing.assert_allclose(back, np.floor(img * 255) / 255, atol=1e-6)
    images.save_std_dev_map(np.stack([img, img[::-1]]), str(tmp_path / "s.png"))
    assert Image.open(tmp_path / "s.png").size == (16, 16)
    assert images.list_dataset(str(tmp_path)) == [str(tmp_path / "a.png"),
                                                  str(tmp_path / "s.png")]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_randn_draws_on_the_host(device):
    """The CLI's y0 noise and initial chain state are drawn on the host from
    a CPU generator seeded seed + idx and then moved: on the CPU they are
    that generator's values, and on the meta device, where no generator
    exists, the helper still gives a tensor and advances the host generator
    by the same draw."""
    seed, idx, shape = 1234, 3, (2, 5, 3)
    host = torch.Generator().manual_seed(seed + idx)
    got = cli.host_randn(shape, host, torch.device(device))
    ref = torch.Generator("cpu").manual_seed(seed + idx)
    want = torch.randn(shape, generator=ref)
    assert got.device.type == device and got.shape == want.shape and got.dtype == torch.float32
    if device == "cpu":
        assert torch.equal(got, want)
    assert torch.equal(torch.randn(4, generator=host), torch.randn(4, generator=ref))


def test_image_generators_keep_the_host_draws_on_the_cpu():
    host, engine = cli.image_generators(41, torch.device("cpu"))
    assert host.device.type == "cpu" and host.initial_seed() == 41
    assert engine is host  # the CPU engine continues the host stream


@pytest.mark.parametrize("algo", ["hmc", "hmc_latent"])
def test_cli_draws_y0_noise_and_initial_state_on_the_host(tmp_path, monkeypatch, algo):
    """Both CLIs draw y0's noise, then the chains' initial state, from the
    image's host generator (seed + idx), in that order."""
    calls = []
    real = cli.host_randn

    def spy(shape, generator, device):
        calls.append((tuple(shape), generator.device.type, generator.initial_seed()))
        out = real(shape, generator, device)
        calls[-1] += (out.clone(),)
        return out

    monkeypatch.setattr(cli, "host_randn", spy)
    data = _synthetic_dataset(tmp_path / "data")
    cfg = CFG if algo == "hmc" else os.path.join(os.path.dirname(CFG), "tiny_latent_test.yaml")
    steps = (["--hmc_epochs", "1", "--hmc_sampling", "1"] if algo == "hmc"
             else ["--latent_epochs", "1", "--latent_sampling", "0"])
    cli.main(["--config", cfg, "-i", str(tmp_path / "out"), "--data_path", str(data),
              "--device", "cpu", "--no-bf16", "--algo", algo, "--chains", "2", "--seed", "5",
              "--tau", "0.1", "--epsilon", "0.05", *steps])
    assert [c[1:3] for c in calls] == [("cpu", 5), ("cpu", 5)]
    (y_shape, *_, noise), (x_shape, *_, x_t) = calls
    assert x_shape[0] == 2 and len(y_shape) == 2
    ref = torch.Generator("cpu").manual_seed(5)
    assert torch.equal(noise, torch.randn(y_shape, generator=ref))
    assert torch.equal(x_t, torch.randn(x_shape, generator=ref))
