"""nshmc_tpu_torch stands alone: no JAX and nothing of nshmc_tpu in the port
or in chip_smoke.py, and its entry point runs on CUDA unless told not to."""
import ast
import importlib
import inspect
import os
import pkgutil

import pytest
import torch

import nshmc_tpu_torch
from nshmc_tpu_torch import cli

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nshmc_tpu")

torch.set_num_threads(2)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nshmc_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert any(f.endswith("chip_smoke.py") for f in files) and len(files) > 10
    rel = {os.path.relpath(f, ROOT) for f in files}
    for module in ("models/ldm/autoencoder.py", "models/ldm/distributions.py",
                   "models/ldm/ldm.py", "models/ldm/port.py", "models/ldm/__init__.py",
                   "hmc/latent.py", "cli_latent.py",  # the latent path is checked too
                   "operators/base.py", "operators/linear.py", "operators/deblur.py",
                   "operators/cs.py", "operators/nonlinear.py", "operators/general.py",
                   "operators/nonlinear_blur.py", "models/kernel_wizard.py",
                   # the noise-space samplers' and solvers' modules
                   "hmc/adaptation.py", "utils/diagnostics.py", "utils/checkpointing.py",
                   "solvers/dmplug.py", "solvers/__init__.py",
                   # the iterative baselines' modules
                   "algos/__init__.py", "algos/base.py", "algos/spectral.py",
                   "algos/guided.py", "algos/optim_based.py", "algos/resample.py",
                   "sampling/loop.py", "sampling/resample_original.py",
                   "solvers/sf_adamw.py", "solvers/adamw.py",
                   # the remaining models and utilities
                   "models/ddpm_simple.py", "models/ldm/transformer.py", "models/__init__.py",
                   "utils/lpips.py", "utils/datasets.py", "utils/lmdb_reader.py",
                   "utils/profiling.py", "utils/ckpt_util.py",
                   # chain sharding over processes
                   "parallel/__init__.py", "parallel/chains.py", "parallel/multihost.py"):
        assert os.path.join("nshmc_tpu_torch", module) in rel, module
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _device_defaults():
    """(qualified name, default) of every `device` parameter of the port's
    public functions, methods and classmethods."""
    found = []
    for info in pkgutil.walk_packages(nshmc_tpu_torch.__path__, "nshmc_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            members = [(name, obj)]
            if inspect.isclass(obj):
                members += [(f"{name}.{m}", getattr(obj, m)) for m, v in vars(obj).items()
                            if m == "__init__" or not m.startswith("_")]
            for qual, fn in members:
                if not callable(fn) or inspect.isclass(fn):
                    continue
                try:
                    params = inspect.signature(fn).parameters
                except (TypeError, ValueError):
                    continue
                if "device" in params:
                    found.append((f"{mod.__name__}.{qual}", params["device"].default))
    return found


def test_entry_points_default_to_cuda():
    """A caller who leaves out `device` gets the card, never a silent CPU run."""
    found = dict(_device_defaults())
    for entry in ("nshmc_tpu_torch.hmc.engine.init_chains",
                  "nshmc_tpu_torch.operators.build_operator",
                  "nshmc_tpu_torch.operators.linear.Inpainting.__init__",
                  "nshmc_tpu_torch.operators.linear.SuperResolution.create",
                  "nshmc_tpu_torch.operators.deblur.Deblurring2D.aniso",
                  "nshmc_tpu_torch.operators.deblur.SRConv.bicubic",
                  "nshmc_tpu_torch.operators.cs.WalshHadamardCS.create",
                  "nshmc_tpu_torch.operators.nonlinear.PhaseRetrieval.create",
                  "nshmc_tpu_torch.operators.nonlinear_blur.NonlinearBlur.create",
                  "nshmc_tpu_torch.operators.nonlinear_blur.NonlinearBlur.create_bkse",
                  "nshmc_tpu_torch.schedules.DiffusionSchedule.create",
                  "nshmc_tpu_torch.schedules.DiffusionSchedule.from_alphas_cumprod",
                  "nshmc_tpu_torch.models.port.load_adm_checkpoint",
                  "nshmc_tpu_torch.hmc.latent.init_latent_chains",
                  "nshmc_tpu_torch.hmc.adaptation.init_conditioned_chains",
                  "nshmc_tpu_torch.hmc.adaptation.DualAveragingState.create",
                  "nshmc_tpu_torch.models.ldm.ldm.LatentDiffusion.create",
                  "nshmc_tpu_torch.models.ddpm_simple.load_ddpm_checkpoint",
                  "nshmc_tpu_torch.utils.lpips.try_load_lpips",
                  "nshmc_tpu_torch.parallel.chains.chain_mesh",
                  "nshmc_tpu_torch.parallel.multihost.rank_device"):
        assert found.get(entry) == "cuda", (entry, found.get(entry))
    assert not [k for k, v in found.items() if str(v) == "cpu"], found


def test_cli_default_device_is_cuda():
    assert cli.get_parser().parse_args([]).device == "cuda"


def test_cli_refuses_to_fall_back_to_cpu(tmp_path):
    """Without --device cpu, a host without CUDA gets an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    cfg = os.path.join(ROOT, "configs", "tiny_test.yaml")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", cfg, "-i", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
