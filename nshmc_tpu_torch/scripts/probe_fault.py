"""How sharp the P1/P4 stats check is: a planted fault in P4, read against
the sound kernels.

P4 sums x^2 on bf16 tensor cores as ones . hi + ones . lo, where
hi = bf16(x^2) and lo = bf16(x^2 - hi), so that the sum is exact. This
script builds, in a temporary directory, a copy of `csrc/stream_probe.cu`
whose P4 drops the lo product (its sum x^2 then adds bf16-rounded squares),
runs it and the sound P1 and P4 on the stream probe's input, and prints one
JSON line per kernel: max |kernel - channel_stats_plain| for each statistic,
that over max |sum|, and whether the stats tolerance of
`scripts/stream_probe.py` passes it. The check is worth something only if
the faulty kernel fails it.

    python -m nshmc_tpu_torch.scripts.probe_fault [--shape 8,65536,128]

Needs a CUDA card and nvcc. The source tree is not written.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

from ..ops import _build
from ..ops import groupnorm as gn
from ..ops import stream_probe as sp
from ._bench import card, resolve_device
from .stream_probe import TOLERANCES, make_inputs

# the line of P4 that adds ones . lo onto ones . hi
LO_PRODUCT = "        mma_ones(e, l0, l1, e[0], e[1], e[2], e[3]);\n"


def faulty_source() -> str:
    """csrc/stream_probe.cu with P4's lo product removed."""
    with open(os.path.join(_build.CSRC, "stream_probe.cu")) as f:
        src = f.read()
    if src.count(LO_PRODUCT) != 1:
        raise RuntimeError("P4's lo product is not one line of csrc/stream_probe.cu: "
                           "update LO_PRODUCT")
    return src.replace(LO_PRODUCT, "")


def build_faulty(tmp: str) -> ctypes.CDLL:
    """Compile the faulty source in `tmp` with the port's nvcc flags."""
    cu, so = os.path.join(tmp, "stream_probe_no_lo.cu"), os.path.join(tmp, "stream_probe_no_lo.so")
    with open(cu, "w") as f:
        f.write(faulty_source())
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on the faulty copy:\n{r.stderr}")
    return sp.declare(ctypes.CDLL(so))


def reading(got, ref) -> dict:
    """Per statistic (sum x, sum x^2): max |d|, max |d| / max |sum|, and
    whether the stats tolerance passes it."""
    out = {}
    for i, stat in enumerate(("sum_x", "sum_x2")):
        d = float((got[:, i] - ref[:, i]).abs().max())
        top = float(ref[:, i].abs().max())
        out[stat] = {"max_abs_err": d, "rel_to_max_sum": d / top,
                     "passes": d <= TOLERANCES["stats"] * top}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m nshmc_tpu_torch.scripts.probe_fault",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", default="8,65536,128", help="B,R,C")
    args = p.parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    dev = resolve_device("cuda")
    x = make_inputs(shape)[0]
    ref = gn.channel_stats_plain(x)
    with tempfile.TemporaryDirectory() as tmp:
        faulty = build_faulty(tmp)
        results = {"probe_stats": reading(sp.probe_stats(x), ref),
                   "probe_mma_stats": reading(sp.probe_mma_stats(x), ref),
                   "probe_mma_stats_without_lo": reading(
                       sp.stats_launch(x, "nshmc_probe_mma_stats", faulty), ref)}
    for name, res in results.items():
        print(json.dumps({"kernel": name, "shape": list(shape),
                          "tolerance": f"|d| <= {TOLERANCES['stats']} max|sum|", **res}))
    card_line = card(dev)
    print(card_line)
    return {"card": card_line, **results}


if __name__ == "__main__":
    main()
