"""The self-attention sites of one evaluation of a conditional latent U-Net
and the least time their kernel (K1, csrc/attention.cu) needs, beside
sites.py's GroupNorm sites: each call of a SpatialTransformer block's
`attn1` (recorded by forward hooks) as (B, T, heads, d_head) and element
size. A call's least time is the larger of its bytes (q, k and v read once,
the output written once: 4 B T H d elements) over the HBM rate and its
operations (q k^T and the weights times v: 4 B H T^2 d) over the peak.

The system under test (systems/sd_latent_hmc.py) fills LOG: the sites of
the evaluation the benchmark counts GroupNorm sites in (run.py, --trace 1),
and the K1 launch counter's moves over each run of the sampler, with its
host-clock bounds, so that a reader finds the run a trace's window holds."""
from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Call:
    shape: tuple    # (B, T, heads, d_head)
    elem_size: int

    def least_s(self, hbm_bytes_per_s: float, flops_per_s: float) -> float:
        b, t, h, d = self.shape
        return max(4 * b * t * h * d * self.elem_size / hbm_bytes_per_s,
                   4 * b * h * t * t * d / flops_per_s)


class Log:
    def __init__(self):
        self.found: Optional[List[Call]] = None
        self.runs = collections.deque(maxlen=64)  # (start ns, end ns, K1 launches)

    def launches_within(self, t0_ns: int, t1_ns: int) -> Optional[int]:
        """The K1 launches of the one run inside [t0_ns, t1_ns], or None."""
        inside = [n for s, e, n in self.runs if s >= t0_ns and e <= t1_ns]
        return inside[0] if len(inside) == 1 else None


LOG = Log()


def k1_launches() -> int:
    from nshmc_tpu_torch.ops import attention

    return attention.attention_forward.launches


def count(roots, run_eval) -> Tuple[List[Call], object]:
    """(the calls, run_eval()'s result): one evaluation with hooks on every
    `attn1` module under `roots`."""
    calls, handles = [], []

    def hook(mod, args, out):
        b, t, _ = args[0].shape
        calls.append(Call((b, t, mod.heads, mod.dim_head), args[0].element_size()))

    for root in roots:
        for name, m in root.named_modules():
            if name.endswith(".attn1"):
                handles.append(m.register_forward_hook(hook))
    try:
        out = run_eval()
    finally:
        for h in handles:
            h.remove()
    return calls, out
