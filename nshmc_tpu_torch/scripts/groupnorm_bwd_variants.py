"""K2c's two designs timed side by side on the card: the one-launch
GN+SiLU backward (`nshmc_gn_bwd`, x and g read once) against the two-pass
design (`nshmc_gn_bwd_twopass`, slab partials, a finish kernel and a dx pass
that reads x and g again: five passes, three launches), both from
csrc/groupnorm_bwd.cu as the wrapper builds it.

    python -m nshmc_tpu_torch.scripts.groupnorm_bwd_variants [--iters N]

At each of the flagship's 18 GN+SiLU shapes (kernel_check.FLAGSHIP_GN_SITES)
in bf16 and f32, with a (B, C) affine as on the main path, both designs are
held to the plain version with `kernel_check`'s K2c tolerance, then timed in
turns (one-launch, two-pass, two-pass, one-launch); a design's time is the
mean of its two turns. Device ms per call comes from CUDA graphs of --iters
calls (the host's launch cost left out: at the small shapes it exceeds the
kernels'); where the card refuses to capture a launch, from CUDA events over
back-to-back calls, and the line says so. Eager ms per call (CUDA events,
host included) is printed beside it. One JSON line per case, with the
three-pass bound and the five-pass floor at 3.35 TB/s and the design
`bwd_design` picks; then one summary line: the K2c device ms of one bf16
U-Net forward (each shape's time times its sites) for each design alone and
for the picks, and whether every pick is the faster design. Needs a CUDA
card and nvcc; writes no file.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import groupnorm as gn
from . import kernel_check as kc
from ._bench import HBM_GB_S, card, resolve_device, time_s, time_s_graph

DESIGNS = {"one_launch": gn.launch_one, "twopass": gn.launch_twopass}


def device_ms(fn, dev, iters: int, graphs: bool):
    """(device ms per call, "graph" or "events")."""
    if graphs:
        return 1e3 * time_s_graph(fn, iters=iters, reps=3), "graph"
    return 1e3 * time_s(fn, dev, iters, warmup=3), "events"


def can_capture(dev) -> bool:
    """Whether both designs' launches can be captured in a CUDA graph."""
    inputs = kc.gn_inputs((2, 256, 64), torch.bfloat16, "per_batch_channel",
                          torch.Generator(device=dev).manual_seed(1), dev)
    try:
        for fn in DESIGNS.values():
            time_s_graph(lambda: fn(*inputs), iters=2, reps=1)
        return True
    except RuntimeError as e:
        print(f"CUDA graph capture refused ({str(e).splitlines()[0]}): device times "
              f"from CUDA events")
        torch.cuda.synchronize(dev)
        return False


def time_case(shape, dt, gen, dev, sms: int, iters: int, graphs: bool) -> dict:
    """Check and time both designs at one shape; one JSON line."""
    inputs = kc.gn_inputs(shape, dt, "per_batch_channel", gen, dev)
    want = gn.groupnorm_silu_backward_plain(*inputs)
    checks = {name: kc.gn_backward_agreement(fn(*inputs), want) for name, fn in DESIGNS.items()}
    del want
    dev_ms = {name: [] for name in DESIGNS}
    eager = {name: [] for name in DESIGNS}
    order = list(DESIGNS)
    how = "events"
    for name in order + order[::-1]:
        fn = DESIGNS[name]
        ms, how = device_ms(lambda: fn(*inputs), dev, iters, graphs)
        dev_ms[name].append(ms)
        eager[name].append(1e3 * time_s(lambda: fn(*inputs), dev, iters, warmup=2))
    b, r, c = shape
    elem = inputs[0].element_size()
    n = b * r * c
    row = {"shape": list(shape), "dtype": str(dt).split(".")[1], "timing": how,
           **{f"{name}_ms": sum(v) / len(v) for name, v in dev_ms.items()},
           **{f"{name}_turns_ms": v for name, v in dev_ms.items()},
           **{f"{name}_eager_ms": sum(v) / len(v) for name, v in eager.items()},
           "bound_ms": 3 * n * elem / (HBM_GB_S * 1e9) * 1e3,
           "five_pass_floor_ms": 5 * n * elem / (HBM_GB_S * 1e9) * 1e3,
           "picked": gn.bwd_design(b, r, c, elem, sms),
           "agrees": all(ch["ok"] for ch in checks.values()),
           "dx_err": {name: ch["dx_err"] for name, ch in checks.items()}}
    row["faster"] = min(DESIGNS, key=lambda name: row[f"{name}_ms"])
    print(json.dumps(row))
    return row


def summary(rows) -> dict:
    """K2c device ms of one bf16 U-Net forward for each design alone and for
    the wrapper's picks; whether each pick is the faster design."""
    bf16 = [r_ for r_ in rows if r_["dtype"] == "bfloat16"]
    sites = {tuple(r_["shape"]): kc.FLAGSHIP_GN_SITES[tuple(r_["shape"])] for r_ in bf16}
    per_fwd = {name: sum(r_[f"{name}_ms"] * sites[tuple(r_["shape"])] for r_ in bf16)
               for name in DESIGNS}
    per_fwd["picked"] = sum(r_[f"{r_['picked']}_ms"] * sites[tuple(r_["shape"])] for r_ in bf16)
    per_fwd["faster"] = sum(r_[f"{r_['faster']}_ms"] * sites[tuple(r_["shape"])] for r_ in bf16)
    wrong = [(r_["shape"], r_["dtype"]) for r_ in rows if r_["picked"] != r_["faster"]]
    return {"k2c_device_ms_per_bf16_forward": per_fwd, "picks_the_faster": not wrong,
            "picks_the_slower_at": wrong,
            "one_launch_max_slabs": gn.BWD_ONE_LAUNCH_MAX_SLABS}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    graphs = can_capture(dev)
    rows = [time_case(shape, dt, gen, dev, sms, args.iters, graphs)
            for dt in (torch.bfloat16, torch.float32) for shape in kc.FLAGSHIP_GN_SITES]
    print(json.dumps(summary(rows)))
    print(card(dev))
    return rows


if __name__ == "__main__":
    main()
