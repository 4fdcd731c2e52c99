"""nshmc_tpu_torch's LPIPS-VGG against the JAX package's, with random
weights in torchvision's `features.*` and lpips' `lin{i}.model.1` layouts
ported by each package's `port_lpips_weights`; the local-only loader
`try_load_lpips` (files under TORCH_HOME and a stand-in `lpips` package,
written to tmp_path; no socket is opened); and both CLIs' records with the
metric (tiny configs, --device cpu)."""
import json
import os
import socket
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.utils import lpips as jl
from nshmc_tpu_torch import cli
from nshmc_tpu_torch.utils import lpips as tl
from test_torch_cli import _synthetic_dataset

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
CFG = os.path.join(HERE, "..", "configs", "tiny_test.yaml")
LATENT_CFG = os.path.join(HERE, "..", "configs", "tiny_latent_test.yaml")


def synth_state_dicts(seed=0):
    """Random weights in the exact torchvision VGG16 / lpips layouts (He
    scaled, so the features stay O(1) through 13 convs), plus torchvision's
    classifier keys, which the port ignores."""
    g = torch.Generator().manual_seed(seed)
    vgg_sd, in_ch = {}, 3
    chans = [ch for ch, n in tl._VGG_STAGES for _ in range(n)]
    for idx, out_ch in zip(tl.TV_CONV_IDX, chans):
        vgg_sd[f"features.{idx}.weight"] = (torch.randn(out_ch, in_ch, 3, 3, generator=g)
                                            * (2.0 / (9 * in_ch)) ** 0.5)
        vgg_sd[f"features.{idx}.bias"] = 0.05 * torch.randn(out_ch, generator=g)
        in_ch = out_ch
    vgg_sd["classifier.6.bias"] = torch.zeros(10)
    lin_sd = {f"lin{i}.model.1.weight": torch.rand(1, ch, 1, 1, generator=g)
              for i, (ch, _) in enumerate(tl._VGG_STAGES)}
    return vgg_sd, lin_sd


def port_model(vgg_sd, lin_sd):
    m = tl.LPIPS()
    m.load_state_dict(tl.port_lpips_weights(vgg_sd, lin_sd), strict=True)
    return m.eval()


def test_lpips_matches_jax():
    vgg_sd, lin_sd = synth_state_dicts()
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    jax_sd = {k: v.numpy() for k, v in vgg_sd.items() if k.startswith("features.")}
    ref = jl.LPIPS().apply(jl.port_lpips_weights(jax_sd, {k: v.numpy() for k, v in
                                                         lin_sd.items()}),
                           jnp.asarray(a), jnp.asarray(b))
    out = port_model(vgg_sd, lin_sd)(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (2,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
    assert float(out.min()) > 0


def test_identity_is_zero():
    m = port_model(*synth_state_dicts())
    a = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 3)).astype(
        np.float32))
    np.testing.assert_allclose(m(a, a).numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("missing", ["features.28.weight", "lin3.model.1.weight"])
def test_missing_keys_raise(missing):
    vgg_sd, lin_sd = synth_state_dicts()
    (vgg_sd if missing.startswith("features") else lin_sd).pop(missing)
    with pytest.raises(KeyError):
        tl.port_lpips_weights(vgg_sd, lin_sd)


@pytest.fixture(scope="module")
def weight_dir(tmp_path_factory):
    """TORCH_HOME with torchvision's VGG16 cache file and a stand-in `lpips`
    package with its heads, both random (only the VGG features, ~59 MB)."""
    root = tmp_path_factory.mktemp("lpips_weights")
    vgg_sd, lin_sd = synth_state_dicts(3)
    ckpt = root / "torch" / "hub" / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(vgg_sd, ckpt / tl.VGG16_FILE)
    heads = root / "site" / "lpips" / "weights" / "v0.1"
    heads.mkdir(parents=True)
    (root / "site" / "lpips" / "__init__.py").write_text("")
    torch.save(lin_sd, heads / "vgg.pth")
    return root, vgg_sd, lin_sd


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a socket was opened")

    for name in ("socket", "create_connection", "getaddrinfo"):
        monkeypatch.setattr(socket, name, refuse)


@pytest.fixture
def local_weights(weight_dir, monkeypatch, no_network):
    root, vgg_sd, lin_sd = weight_dir
    monkeypatch.setenv("TORCH_HOME", str(root / "torch"))
    monkeypatch.syspath_prepend(str(root / "site"))
    return vgg_sd, lin_sd


def test_try_load_lpips_none_without_files(tmp_path, monkeypatch, no_network):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    assert tl.try_load_lpips(device="cpu") is None
    assert not (tmp_path / "empty").exists()  # nothing written, nothing fetched


def test_try_load_lpips_loads_local_files(local_weights):
    vgg_path, heads_path = tl.weight_files()
    assert os.path.isfile(vgg_path) and os.path.isfile(heads_path)
    m = tl.try_load_lpips(device="cpu")
    ref = port_model(*local_weights)
    a, b = (torch.from_numpy(np.random.default_rng(s).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)) for s in (4, 5))
    assert torch.equal(m(a, b), ref(a, b))


def test_weight_files_ignore_a_stand_in_module(local_weights, monkeypatch):
    """A module named lpips already in sys.modules without a spec (as
    tests/_reference_shim.py installs one) does not hide the files."""
    monkeypatch.setitem(sys.modules, "lpips", types.ModuleType("lpips"))
    assert os.path.isfile(tl.weight_files()[1])
    assert tl.try_load_lpips(device="cpu") is not None


def test_try_load_lpips_raises_on_a_corrupt_file(local_weights, tmp_path, monkeypatch):
    """Only absent files give None; a file that does not load raises."""
    bad = tmp_path / "torch" / "hub" / "checkpoints"
    bad.mkdir(parents=True)
    (bad / tl.VGG16_FILE).write_bytes(b"not a checkpoint")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch"))
    with pytest.raises(Exception):
        tl.try_load_lpips(device="cpu")


@pytest.mark.parametrize("cfg,algo,flags", [
    (CFG, "ddnm", []),
    (LATENT_CFG, "hmc_latent", ["--latent_epochs", "1", "--latent_sampling", "1",
                                "--chains", "2"]),
], ids=["pixel", "latent"])
def test_cli_records_hold_lpips(tmp_path, capsys, local_weights, cfg, algo, flags):
    data = _synthetic_dataset(tmp_path / "data")
    out = tmp_path / "out"
    summary = cli.main(["--config", cfg, "-i", str(out), "--data_path", str(data),
                        "--device", "cpu", "--no-bf16", "--algo", algo, *flags])
    rec = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(rec["lpips"]) and rec["lpips"] >= 0
    assert np.isfinite(summary["lpips"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "LPIPS: VGG weights loaded" in lines
    assert json.loads(lines[-1]) == {"summary": summary}
