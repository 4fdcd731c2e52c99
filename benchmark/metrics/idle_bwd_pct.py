"""Share of the profiled attempt's window with the device idle while the
host is inside the program's `hmc.backward` spans: autograd's launches of
the input gradient (spans.py)."""
import spans

KERNELS = ()


def read(ctx):
    split = spans.idle_split(ctx.trace)
    return None if split is None else split["backward"]
