"""The GroupNorm sites of one evaluation and the bytes their kernels must
move (the forward-hook logic of nshmc_tpu_torch/scripts/kernel_check.py::
count_sites, copied): each call of a GroupNorm+SiLU or GroupNorm32 module,
its (B, rows, C) shape and element size, whether it ran inside the loss call
(the forward) or after it (activation checkpointing's recompute in the
backward), and whether its output takes part in the gradient.

Bytes are the least a kernel must move, each input read once and each
output written once:
  - GN+SiLU forward (K2a statistics, then K2b apply): x read by the
    statistics, x read and y written by the apply: 3 x bytes of x;
  - GroupNorm32 (K2a statistics only): 1 x bytes of x;
  - GN+SiLU backward (K2c), one per forward call whose output is in the
    gradient's graph: x and g read, dx written: 3 x bytes of x."""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Call:
    kind: str         # "gn_silu" or "gn32"
    shape: tuple      # (B, rows, C)
    elem_size: int
    in_forward: bool  # inside the loss call, not a recompute in the backward
    in_graph: bool    # its output requires grad

    @property
    def nbytes(self) -> int:
        b, r, c = self.shape
        return b * r * c * self.elem_size


@dataclasses.dataclass
class Sites:
    calls: List[Call]

    def count(self, kind: str) -> int:
        return sum(c.kind == kind for c in self.calls)

    @property
    def backward(self) -> List[Call]:
        return [c for c in self.calls if c.kind == "gn_silu" and c.in_forward and c.in_graph]

    @property
    def fwd_bytes(self) -> int:
        return sum((3 if c.kind == "gn_silu" else 1) * c.nbytes for c in self.calls)

    @property
    def bwd_bytes(self) -> int:
        return sum(3 * c.nbytes for c in self.backward)

    def expected_launches(self) -> dict:
        """The program's launch counters an evaluation should add: K2a
        (group_stats) once a GroupNorm call, K2b (normalize_silu) once a
        GN+SiLU call, K2c (groupnorm_silu_backward) once a backward site."""
        n = self.count("gn_silu")
        return {"group_stats": n + self.count("gn32"), "normalize_silu": n,
                "groupnorm_silu_backward": len(self.backward)}


def count(roots, run_eval, loss_fn) -> Sites:
    """One evaluation, run_eval(wrapped loss_fn), with hooks on every
    GroupNorm module under `roots`."""
    from nshmc_tpu_torch.models.nn import GroupNorm32, GroupNormSiLU

    calls, phase = [], {"forward": False}

    def hook(kind):
        def fn(mod, args, out):
            b, c, h, w = args[0].shape
            calls.append(Call(kind, (b, h * w, c), args[0].element_size(), phase["forward"],
                              bool(out.requires_grad)))
        return fn

    handles = []
    for root in roots:
        for m in root.modules():
            if isinstance(m, GroupNormSiLU):
                handles.append(m.register_forward_hook(hook("gn_silu")))
            elif isinstance(m, GroupNorm32):
                handles.append(m.register_forward_hook(hook("gn32")))

    def wrapped(x):
        phase["forward"] = True
        try:
            return loss_fn(x)
        finally:
            phase["forward"] = False

    try:
        run_eval(wrapped)
    finally:
        for h in handles:
            h.remove()
    return Sites(calls)


def counters() -> dict:
    """The program's own launch counters (ops/groupnorm.py's wrappers)."""
    from nshmc_tpu_torch.ops import groupnorm as gn

    return {"group_stats": gn.group_stats.launches, "normalize_silu": gn.normalize_silu.launches,
            "groupnorm_silu_backward": gn.groupnorm_silu_backward.launches}
