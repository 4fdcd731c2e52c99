"""Device kernels launched in the profiled attempt (copies and sets left
out), over its evaluations: the host's launch work an evaluation."""
KERNELS = ()


def read(ctx):
    n = len(ctx.trace.kernels())
    return n / ctx.evals if n else None
