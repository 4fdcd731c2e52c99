#!/usr/bin/env python3
"""The Stable Diffusion cell's readings against the control that runs the
configuration's float32 islands (GroupNorm, LayerNorm, softmax) in bfloat16:
readings.py's run with the bfloat16 reference in the program's place and
reference/sd_latent_hmc.py's `islands` set on it.

    python3 benchmark/tests/readings_islands.py --seeds 1,2,3 \\
        [--workload sd21_base.hmc8_inpaint_prompt] [--seconds 0]

Prints one JSON line a seed, as readings.py does. Needs a CUDA card."""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def islands_bf16(program):
    """run.run_cell's `patch`: the control problem, whose loss callable has
    taken the program's place, runs its islands in bfloat16."""
    import torch

    program.loss_fn.__self__.islands = torch.bfloat16


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="sd21_base.hmc8_inpaint_prompt")
    p.add_argument("--seeds", required=True)
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
        out = run.run_cell(cell, seed, args.seconds, 0, device, "bfloat16", patch=islands_bf16)
        w = out["window"]
        print(json.dumps({"seed": seed, "control": "bfloat16_islands", "correct": out["correct"],
                          "worst": out["worst"], "readings": out["readings"],
                          "chain_evals_per_s": w.chains * w.n_evals / w.wall_s}), flush=True)
        run.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
