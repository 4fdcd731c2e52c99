#!/usr/bin/env python3
"""The readings that the limits in workloads/*.json are set from: one cell's
check numbers over many seeds, in one process, through the benchmark's own
run (run.run_cell), the program or a control in its place.

    python3 benchmark/tests/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control bfloat16|fp8] [--seconds 0]

Prints one JSON line a seed: the worst chain's and the median chain's
numbers and the readings beside them. Needs a CUDA card."""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(os.path.dirname(HERE), ".cache", "triton")
    import torch

    import cells
    import run

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell, device = cells.load(args.workload), torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, args.seconds, 0, device, args.control)
        w = out["window"]
        print(json.dumps({"seed": seed, "control": args.control, "correct": out["correct"],
                          "worst": out["worst"], "readings": out["readings"],
                          "chain_evals_per_s": w.chains * w.n_evals / w.wall_s}), flush=True)
        run.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
