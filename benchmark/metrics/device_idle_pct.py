"""Share of the profiled attempt's host-clock window with nothing running on
the device (the union of kernel, copy and set intervals)."""
KERNELS = ()


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
