"""Multi-process execution (port of nshmc_tpu/parallel/multihost.py).

One process per device: each process runs its share of the work on its own
device, and the only collectives are host-side gathers over a gloo process
group (a handful a run: the chain states of a sharded run, the metric rows).
NCCL would refuse two ranks on one GPU, and its speed buys nothing for one
gather an image.

Usage (each process):

    from nshmc_tpu_torch.parallel import multihost as mh
    mh.maybe_initialize()                 # env-gated process-group init
    device = mh.rank_device("cuda")       # this rank's card
    files = mh.shard_files(files)         # this process's slice of the dataset
    ...run...
    rows = mh.gather_records(local_rows)  # every process gets every row
    if mh.is_primary():
        write(rows)
    mh.shutdown()                         # once every process is done

Environment contract (the JAX package's):
    NSHMC_DIST=1                enable the process group
    NSHMC_COORDINATOR=host:port rendezvous address (tcp://host:port)
    NSHMC_NUM_PROCESSES=N       total process count
    NSHMC_PROCESS_ID=i          this process's rank
With NSHMC_DIST=1 alone the group reads torchrun's environment (env://:
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), e.g.

    NSHMC_DIST=1 torchrun --nproc_per_node 2 -m nshmc_tpu_torch.cli --mesh 2 ...

Without a process group every helper is the identity or a no-op.
`launch_local` starts N local ranks under this contract (the tests' and the
chip smoke run's launcher).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def maybe_initialize() -> bool:
    """Join the gloo process group if NSHMC_DIST=1. Returns True when running
    multi-process (after the init), False on the ordinary single-process
    path. Idempotent."""
    if dist.is_initialized():
        return True
    if os.environ.get("NSHMC_DIST", "") != "1":
        return False
    coord = os.environ.get("NSHMC_COORDINATOR", "")
    if coord:
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=int(os.environ["NSHMC_NUM_PROCESSES"]),
                                rank=int(os.environ["NSHMC_PROCESS_ID"]))
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def rank_device(device="cuda") -> torch.device:
    """This rank's device for `device`: an indexed device (`cuda:K`, `cpu`)
    as given; with a process group, bare `cuda` is `cuda:{LOCAL_RANK}` under
    torchrun, else `cuda:{process_index % device_count}`."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or process_count() == 1:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else process_index() % torch.cuda.device_count()
    return torch.device("cuda", index)


def shard_files(files: Sequence[Any]) -> List[Any]:
    """This process's strided slice of the dataset: process i takes
    files[i::P]. Single-process: every file."""
    return list(files)[process_index()::process_count()]


def gather_records(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """All-gather small picklable per-process records (metric rows). Every
    process receives the concatenated list, ordered by process index."""
    if process_count() == 1:
        return list(records)
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, list(records))
    return [r for part in gathered for r in part]


def sync() -> None:
    """Barrier across processes (no-op single-process)."""
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group once every process has reached this point
    (no-op without one). The primary hosts the group's store, so a rank that
    exited while another still used it would take that one down."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def launch_local(argv: Sequence[str], nproc: int, timeout: float, cwd: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run `python argv...` as `nproc` ranks of one process group on
    localhost (the NSHMC_* contract on a free port, `env` added to each
    rank's environment) and return each rank's output, stdout and stderr
    together. Raises RuntimeError where a rank fails; where the ranks
    outlast `timeout` seconds together (a hung rendezvous) every rank is
    killed and it raises."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    try:
        for rank in range(nproc):
            logs.append(tempfile.TemporaryFile("w+"))  # a file, not a pipe: no rank blocks
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=cwd, stdout=logs[-1], stderr=subprocess.STDOUT,
                text=True, env=dict(os.environ, **(env or {}), NSHMC_DIST="1",
                                    NSHMC_COORDINATOR=f"localhost:{port}",
                                    NSHMC_NUM_PROCESSES=str(nproc),
                                    NSHMC_PROCESS_ID=str(rank))))
        deadline = time.monotonic() + timeout
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} of {nproc} outlasted {timeout} s") from None
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {nproc} failed (rc {p.returncode}):\n{out}")
    return outs
