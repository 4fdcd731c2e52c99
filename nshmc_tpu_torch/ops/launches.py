"""The launch counters of the main path's kernel wrappers as one set.

Each wrapper of ops/ counts its kernel's launches in `.launches` when it
runs: K2a `groupnorm.group_stats` (which `channel_stats` shares), K2b
`normalize_silu`, K2c `groupnorm_silu_backward` and its two designs
`launch_one` and `launch_twopass`, K1 `attention.attention_forward`, each
of K1's kernels in `attention.KERNEL_LAUNCHES` and the bf16 kernel's
long-sequence design, `attention.LONG_LAUNCHES`. A CUDA graph's replay runs
no wrapper, so the graph's owner (sampling/graphs.py) reads the set around
the capture with `read` and adds the difference at each replay with
`advance`."""
from __future__ import annotations

from typing import Dict

from . import attention, groupnorm


# the wrappers as this module finds them at import: a caller that puts a plain
# version in a wrapper's place (chip_smoke.py's plain_swaps) leaves the counts here
_COUNTERS = {"group_stats": groupnorm.group_stats, "normalize_silu": groupnorm.normalize_silu,
             "groupnorm_silu_backward": groupnorm.groupnorm_silu_backward,
             "launch_one": groupnorm.launch_one, "launch_twopass": groupnorm.launch_twopass,
             "attention_forward": attention.attention_forward,
             **{c.__name__: c for c in attention.KERNEL_LAUNCHES.values()},
             attention.LONG_LAUNCHES.__name__: attention.LONG_LAUNCHES}


def read() -> Dict[str, int]:
    return {name: c.launches for name, c in _COUNTERS.items()}


def since(before: Dict[str, int]) -> Dict[str, int]:
    """What each counter has added since `before` (a `read()`)."""
    now = read()
    return {name: now[name] - before[name] for name in before}


def advance(counts: Dict[str, int]) -> None:
    """Add counts[name] to each counter (negative counts take back)."""
    for name, n in counts.items():
        if n:
            _COUNTERS[name].launches += n
