"""What the probe scripts share: the device they may use, CUDA-event timing
and the card's identity. A time is measured on a CUDA card or not at all:
on the CPU the scripts run their cases once and report `None`."""
from __future__ import annotations

import subprocess

import torch

HBM_GB_S = 3350.0  # H100 SXM data sheet: 3.35 TB/s


def resolve_device(device: str = "cuda") -> torch.device:
    """The device to run on. "cuda" without a card raises instead of
    falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass --device cpu to run "
                           "the cases once on the CPU (no times are measured there)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return dev


def time_s(fn, dev: torch.device, iters: int, warmup: int = 2):
    """Mean device seconds per call of fn over `iters` back-to-back calls
    after `warmup`, by CUDA events; on the CPU, fn runs once and the result
    is None."""
    if dev.type != "cuda":
        fn()
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / iters


def rate(traffic_bytes: int, seconds):
    """(GB/s, percent of the 3,350 GB/s data-sheet rate), None without a time."""
    if seconds is None:
        return None, None
    gb_s = traffic_bytes / seconds / 1e9
    return gb_s, 100.0 * gb_s / HBM_GB_S


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if dev.type != "cuda":
        return "no card: --device cpu, times not measured"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]
