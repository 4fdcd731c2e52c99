#!/usr/bin/env python3
"""The benchmark of nshmc_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout: builds the
port's sampler as its CLI does, with weights, image, mask, noise, chain
starts and draws made on the card from --seed; warms up (set-up ends
here); drives the chains through the port's own driver for --seconds
(window.py); with --trace 1 also profiles one attempt (profiled.py); frees
the program and holds the attempt sampled from the window against the plain
reference (check.py); prints one JSON line. Exits non-zero without a result
where there is no card (or fewer than the cell asks for), where the port is
absent, or where jax, jaxlib, flax or nshmc_tpu were loaded.

What belongs to one kind of cell is found by name: the program under test
in systems/<system>.py, its reference in reference/<system>.py, the
operator in reference/operators/<deg>.py, the metrics in endtoend/ and
metrics/ by the part of their name before any dot. The limits' readings
(sound runs and the control over many seeds) are taken by
benchmark/tests/readings.py through run_cell.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(1, ROOT)  # the port's package, beside this folder
FORBIDDEN = ("jax", "jaxlib", "flax", "nshmc_tpu")
WARMUP_DRAWS = 1 << 20  # the warm-up attempt's draws, apart from every image's


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def note(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Images:
    """Image i of the run: y0 = H(x) + sigma_0 * noise of a synthetic image,
    and the chains' start x_T ~ N(0, I); both from the seed, on the device,
    with the reference's operator for the traffic's `deg`
    (reference/operators/), its draws from the seed."""

    def __init__(self, cell, seed, device, x_shape):
        import inputs
        from reference import operators

        cfg, tr = cell.config, cell.traffic
        self.size = cfg["data"]["image_size"]
        self.op = operators.build(tr, cfg["data"], inputs.mask_rng(seed), device)
        self.seed, self.device, self.x_shape = seed, device, tuple(x_shape)
        self.sigma = 2.0 * tr["sigma_0"]
        self.chains = tr["chains"]

    def __call__(self, i):
        import torch

        import inputs

        x = 2.0 * torch.from_numpy(inputs.synthetic_image(self.size, self.seed, i)) - 1.0
        y0 = self.op.H(x.to(self.device)[None])[0]
        y0 = y0 + self.sigma * inputs.normal(y0.shape, self.device, self.seed, "noise", i)
        x_t = inputs.normal((self.chains,) + self.x_shape, self.device, self.seed, "start", i)
        return y0, x_t

    def draws(self, i):
        import inputs

        return inputs.Draws((self.chains,) + self.x_shape, self.device, self.seed, i)


def reference_problem(cell, seed, device, op, numerics="float32"):
    import inputs
    from reference import problems

    p = problems.load(cell.config["system"])(cell.config, cell.traffic, op, device)
    for i, m in enumerate(p.models):
        m.load_state_dict(inputs.random_state_dict(inputs.shapes_of(m), device, seed, i),
                          strict=True)
    p.numerics(problems.numerics(numerics))
    p.chunk = cell.workload["check"]["chunk"]
    return p


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def warm_up(program, loss_fn, x_t, images):
    """One attempt through the driver, with draws of their own: every
    kernel and shape the window uses, once."""
    import window

    def stop(state, rnd):
        raise window.WindowClosed()

    try:
        program.run(loss_fn, program.init_state(x_t), images.draws(WARMUP_DRAWS), stop)
    except window.WindowClosed:
        pass


def run_cell(cell, seed: int, seconds: float, trace: int, device, control: str = "",
             patch=None, sample_attempt=None) -> dict:
    """One run of `cell`; returns the result's fields (see main). `control`
    puts the reference in that precision in the program's place; `patch`
    (a test's) changes the program before the run; `sample_attempt`
    (a test's) overrides the attempt drawn from the seed."""
    import torch

    import check
    import sites as site_counts
    import systems
    import window

    system = systems.load(cell.config["system"])
    program = system.Program(cell.config, cell.traffic, seed, device)
    images = Images(cell, seed, device, program.x_shape)
    if control:
        ctl = reference_problem(cell, seed, device, images.op, control)
        program.loss_fn = ctl.loss_fn
    if patch is not None:
        patch(program)
    y0, x_t = images(0)
    loss_fn = program.loss_fn(y0)
    warm_up(program, loss_fn, x_t, images)
    sync(device)
    found = None
    if trace:
        found = site_counts.count(program.roots, lambda f: program.value_and_grad(f, x_t),
                                  loss_fn)
        sync(device)
    setup_s = time.perf_counter() - T_START
    del loss_fn, x_t

    chk = cell.workload["check"]
    attempt = (check.sample_attempt(chk["attempts"][0], chk["attempts"][1], seed)
               if sample_attempt is None else sample_attempt)
    rec = window.Recorder(device, program.n_leapfrog, attempt,
                          cell.traffic["chains"], program.x_shape)
    t_window = time.perf_counter()
    res = window.run_window(program, rec, seconds, cell.traffic["chains"], images,
                            images.draws, device)
    res.setup_s = setup_s
    note(f"{cell.name} seed {seed}: set-up {setup_s:.1f} s, window {res.wall_s:.2f} s, "
         f"{res.attempts} attempts, {res.n_evals} evaluations, sampled attempt "
         f"{rec.sample.attempt}; first evaluations (ms) "
         + " ".join(f"{v:.1f}" for v in res.eval_ms[:4]))
    out = {"window": res, "trace": None}

    if trace:
        out["trace"] = traced_part(cell, program, rec, res, found, device)
    out["peak_bytes"] = res.peak_bytes
    del program, rec.last
    if control:
        del ctl
    free(device)

    t_check = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True  # the reference's fastest float32 algorithms
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ref = reference_problem(cell, seed, device, images.op)
    idx = check.chains_to_follow(cell.traffic["chains"], chk["chains"], seed)
    worst, readings = check.numbers(ref, rec.sample, system.POSITION, idx,
                                    len(rec.sample.loss) - 1, cell.traffic["m"], device)
    correct, compared = check.verdict(worst, cell.workload["limits"])
    note(f"window started {t_window - T_START:.1f} s in; check {time.perf_counter() - t_check:.1f}"
         f" s over chains {readings['chains']}")
    note("numbers " + json.dumps(worst))
    note("per chain: flips " + json.dumps(readings["flips"]) + "; accept (program, reference) "
         + json.dumps([readings["accept_prog"], readings["accept_ref"]]) + "; log ratio minus "
         "log u (reference) " + json.dumps([round(r - u, 2) for r, u in
                                           zip(readings["log_ratio_ref"], readings["log_u"])]))
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.benchmark) = flags
    readings["check_s"] = time.perf_counter() - t_check
    if device.type == "cuda":
        readings["check_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(correct=correct, compared=compared, worst=worst, readings=readings)
    return out


def traced_part(cell, program, rec, res, found, device):
    """The per-layer metrics' context: one more attempt from the window's last
    state, profiled, with the program's launch counters read around it."""
    import flops
    import profiled
    import sites as site_counts
    import traced
    import window
    from reference import problems

    def stop(state, rnd):
        raise window.WindowClosed()

    loss_fn = program.loss_fn(rec.y0)
    draws = rec.draws_last

    def one():
        try:
            program.run(loss_fn, rec.last, draws, stop)
        except window.WindowClosed:
            pass

    before = site_counts.counters()
    tr = profiled.profile(one, host=False)
    after = site_counts.counters()
    tr.named = profiled.profile(one, host=True)
    evals = program.n_leapfrog + 1
    want = found.expected_launches()
    agree = all(after[k] - before[k] == evals * want[k] for k in want)
    if not agree:
        note(f"launch counters moved {dict((k, after[k] - before[k]) for k in want)}, the sites "
             f"predict {dict((k, evals * v) for k, v in want.items())}: no GroupNorm roofline")
    peaks = load_peaks().get(device_kind(device), {})  # none for a CPU: no device metric
    fl = flops.per_eval(problems.load(cell.config["system"]), cell.config, cell.traffic,
                        program.x_shape)
    return traced.Context(trace=tr, evals=evals, sites=found, sites_agree=agree,
                          flops_per_eval=fl, evals_per_s=res.n_evals / res.wall_s,
                          chains=res.chains,
                          peak_flops_per_s=peaks.get(cell.config["peak"]),
                          hbm_bytes_per_s=peaks.get("hbm_bytes_per_s"))


def load_peaks():
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def device_kind(device):
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except Exception:  # the reading is informative only
        return "unknown"


def reader(kind: str, name: str):
    """A metric's reader: <kind>/<name up to its first dot>.py, so that one
    quantity split by cells (`x` and `x.wide`) is read one way."""
    return importlib.import_module(f"{kind}.{name.split('.')[0]}")


def result_line(cell, out, trace: int, device) -> dict:
    metrics = {}
    if trace:
        ctx = out["trace"]
        for m in cell.per_layer:
            v = reader("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = reader("endtoend", m["name"]).read(out["window"])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    w = out["window"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": 1, "memory_peak_bytes": out["peak_bytes"],
           "power_limit": power_limit() if device.type == "cuda" else "none"}
    line = {"correct": out["correct"], "attempted": w.chains * w.n_evals,
            "failed": w.nonfinite, "metrics": metrics, "device": dev}
    if trace:
        t = out["trace"].trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        line["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.named.idle_gaps()}
    line["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["compared"].items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    import torch

    import cells

    cell = cells.load(args.workload)
    want = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        note(f"{args.workload} needs {want} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    try:
        importlib.import_module("nshmc_tpu_torch")
    except ImportError as e:
        note(f"the program is not in this checkout: {e}")
        return 2
    out = run_cell(cell, args.seed, args.seconds, args.trace, device)
    line = result_line(cell, out, args.trace, device)
    bad = forbidden_modules()
    if bad:
        note(f"modules loaded that the benchmark must not load: {', '.join(bad)}")
        return 1
    for k, c in line["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
