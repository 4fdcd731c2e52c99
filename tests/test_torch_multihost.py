"""Multi-process runs of the port's CLIs (nshmc_tpu_torch/parallel/
multihost.py), as tests/test_multihost.py drives the JAX package's: two CPU
processes of one gloo group (tests/_torch_mh_worker.py, spawned here, each
rank under a timeout) through both work decompositions, each against a
single-process run of the same command:
  - cooperative: --mesh 2, the chains of hmc (pixel) and hmc_latent sharded
    over both ranks, every rank on the same image, the primary alone
    writing artifacts, metrics and the summary; the images and metrics
    equal the single-process run's;
  - data-sharded: --mesh <= 1, rank i takes images i::2 and saves them, the
    primary writes the gathered rows in idx order;
plus the single-process fallbacks of the helpers and each rank's device."""
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from nshmc_tpu_torch import cli
from nshmc_tpu_torch.parallel import chains
from nshmc_tpu_torch.parallel import multihost as mh
import _torch_mh_worker as worker
from test_torch_cli import _synthetic_dataset

HERE = os.path.dirname(__file__)
CFG = os.path.join(HERE, "..", "configs", "tiny_test.yaml")
LATENT_CFG = os.path.join(HERE, "..", "configs", "tiny_latent_test.yaml")
SHORT = ["--device", "cpu", "--no-bf16", "--timesteps", "1", "--tau", "0.1", "--epsilon",
         "0.05"]
RUNS = {  # name -> (config, flags, images)
    "hmc": (CFG, ["--algo", "hmc", "--deg", "inpaint_random", "--chains", "4", "--hmc_epochs",
                  "1", "--hmc_sampling", "2", "--mesh", "2"], 1),
    "hmc_latent": (LATENT_CFG, ["--algo", "hmc_latent", "--deg", "inpaint_random", "--chains",
                                "4", "--latent_epochs", "1", "--latent_sampling", "2",
                                "--mesh", "2"], 1),
    "ddnm": (CFG, ["--algo", "ddnm", "--deg", "sr2", "--subset_end", "3"], 3),
}


def _rows(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def _pixels(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module", params=sorted(RUNS))
def two_ranks_and_one(request, tmp_path_factory):
    """(run name, the two ranks' outputs, their folder, the single-process
    run's summary and folder) of one RUNS command."""
    name = request.param
    cfg, flags, n = RUNS[name]
    tmp = tmp_path_factory.mktemp(name)
    data = str(_synthetic_dataset(tmp / "data", n=n))
    argv = ["--config", cfg, "--data_path", data, *SHORT, *flags]
    outs = worker.launch(["cli", *argv, "-i", str(tmp / "two")], 2)
    with worker.one_thread():
        one = cli.main([*argv, "--mesh", "0", "-i", str(tmp / "one")])
    return name, outs, tmp / "two", one, tmp / "one"


def test_two_ranks_write_what_one_process_writes(two_ranks_and_one):
    """The same files, the same pixels and the same metrics; one metrics row
    an image, in idx order."""
    name, _, two, _, one = two_ranks_and_one
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    for f in os.listdir(one):
        if f.endswith(".png"):
            np.testing.assert_array_equal(_pixels(two / f), _pixels(one / f), err_msg=f)
    rows_two, rows_one = _rows(two), _rows(one)
    assert [r["idx"] for r in rows_two] == list(range(RUNS[name][2]))
    for a, b in zip(rows_two, rows_one):
        assert {k: v for k, v in a.items() if k != "wall_s"} == \
               {k: v for k, v in b.items() if k != "wall_s"}


def test_primary_alone_prints_the_summary(two_ranks_and_one):
    """The primary's summary: the owning ranks' running stats merged, so the
    single-process run's summary, keys and all (the sums add in another
    order), and each rank's device."""
    name, outs, _, one, _ = two_ranks_and_one
    summaries = [[json.loads(line) for line in o.splitlines() if line.startswith('{"summary"')]
                 for o in outs]
    assert [len(s) for s in summaries] == [1, 0]
    got = summaries[0][0]["summary"]
    assert sorted(got) == sorted(one)
    for k, v in one.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    for rank, o in enumerate(outs):
        assert f"rank {rank} of 2: device cpu" in o


def test_work_decomposition(two_ranks_and_one):
    """--mesh 2 (hmc, hmc_latent): both ranks run image 0, the chains split;
    --mesh <= 1 (ddnm): rank i runs images i::2."""
    name, outs, _, _, _ = two_ranks_and_one
    ran = [[int(m.group(1)) for m in re.finditer(r"^\[(\d+)\] ", o, re.M)] for o in outs]
    if name == "ddnm":
        assert ran == [[0, 2], [1]]
    else:
        assert ran == [[0], [0]]
    if name == "hmc":
        assert "chains sharded over 2 processes" in outs[0]


@pytest.mark.parametrize("algo,mesh,rank,want", [
    ("hmc", 2, 0, ([0, 1, 2], True)), ("hmc", 2, 1, ([0, 1, 2], False)),
    ("hmc_latent", 2, 1, ([0, 1, 2], False)), ("hmc", 0, 1, ([1], True)),
    ("ddnm", 2, 0, ([0, 2], True)), ("hmc_cond", 2, 1, ([1], True)),
])
def test_work_items(monkeypatch, algo, mesh, rank, want):
    """Several processes: hmc / hmc_latent with --mesh > 1 share every image
    out, the primary writing; every other run (--mesh <= 1, or an algorithm
    that ignores --mesh) is data-sharded, each rank writing its own."""
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    monkeypatch.setattr(mh, "process_index", lambda: rank)
    opt = cli.get_parser().parse_args(["--algo", algo, "--mesh", str(mesh)])
    items, own = cli.work_items(opt, ["a", "b", "c"])
    assert ([i for i, _ in items], own) == want


def test_mesh_refuses_the_image_batch(monkeypatch):
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    opt = cli.get_parser().parse_args(["--algo", "hmc", "--mesh", "2", "--chains", "4",
                                       "--image_batch", "2"])
    with pytest.raises(ValueError, match="--image_batch 2 does not combine with --mesh 2"):
        cli._check_flags(opt)
    opt.image_batch = 1
    cli._check_flags(opt)


def test_single_process_fallbacks(monkeypatch):
    """The helpers are the identity, or no-ops, without a process group."""
    monkeypatch.delenv("NSHMC_DIST", raising=False)
    assert not mh.maybe_initialize()
    assert (mh.process_count(), mh.process_index(), mh.is_primary()) == (1, 0, True)
    assert mh.shard_files(["a", "b", "c"]) == ["a", "b", "c"]
    rows = [{"idx": 0, "psnr": 1.0}]
    assert mh.gather_records(rows) == rows
    mh.sync()
    assert mh.rank_device("cuda") == torch.device("cuda")
    mesh = chains.chain_mesh(1, "cpu")
    assert (mesh.size, mesh.rank, mesh.device, mesh.group) == (1, 0, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="NSHMC_DIST=1 torchrun --nproc_per_node 2"):
        chains.chain_mesh(2, "cpu")
    state = worker.solve("toy8")
    assert chains.make_global_chain_states(mesh, state) is state
    local = chains.fetch_local_shards(mesh, state)
    assert all(torch.equal(a, b) for a, b in zip(vars(local).values(), vars(state).values()))


def test_rank_device_takes_one_card_a_rank(monkeypatch):
    monkeypatch.setattr(mh, "process_count", lambda: 4)
    monkeypatch.setattr(mh, "process_index", lambda: 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mh.rank_device("cuda") == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")  # torchrun's
    assert mh.rank_device("cuda") == torch.device("cuda", 0)
    assert mh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mh.rank_device("cpu") == torch.device("cpu")
