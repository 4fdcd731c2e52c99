"""Share of the profiled attempt's window with the device idle while the
host is in neither a forward nor a backward: the sampler loop's draws,
leapfrog arithmetic, MH step and host syncs (spans.py). With idle_fwd_pct
and idle_bwd_pct it adds up to device_idle_pct."""
import spans

KERNELS = ()


def read(ctx):
    split = spans.idle_split(ctx.trace)
    return None if split is None else split["loop"]
