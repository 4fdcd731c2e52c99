"""Share of the profiled attempt's window with the device idle while the
host is inside the program's `hmc.forward` spans: the loss (the DDIM
ladder's network calls, the VQ decode, the operator) launching too slowly
to keep the device busy (spans.py)."""
import spans

KERNELS = ()


def read(ctx):
    split = spans.idle_split(ctx.trace)
    return None if split is None else split["forward"]
