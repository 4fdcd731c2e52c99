"""The whole evaluation's share of the configuration's peak: useful FLOPs of
one evaluation (flops.py, the plain reference on the meta device) times the
evaluations per second of the run's untraced window, over the peak the
configuration names."""
KERNELS = ()


def read(ctx):
    if not (ctx.flops_per_eval and ctx.evals_per_s and ctx.peak_flops_per_s):
        return None
    return 100.0 * ctx.flops_per_eval * ctx.evals_per_s / ctx.peak_flops_per_s
