"""Chains x evaluations over the wall time of the run's untraced window, as
the end-to-end rate reads it: per layer where the host's pace sets the rate
and its spread between runs is too wide for an end-to-end bound."""
KERNELS = ()


def read(ctx):
    if not ctx.evals_per_s:
        return None
    return ctx.chains * ctx.evals_per_s
