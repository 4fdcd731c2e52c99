"""K2a + K2b, the GroupNorm(+SiLU) forward (csrc/groupnorm_stats.cu's
statistics and ops/groupnorm.py's Triton apply): the least time their calls
in the profiled attempt need (statistics read x once; the apply reads x and
writes y once) over the device time of their kernels. Nothing to read where
the program's own counters disagree with the sites the hooks found."""
KERNELS = ("gn_stats_kernel", "apply_kernel")


def read(ctx):
    if not (ctx.sites_agree and ctx.sites.calls and ctx.hbm_bytes_per_s):
        return None
    seconds = ctx.trace.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    least = ctx.evals * ctx.sites.fwd_bytes / ctx.hbm_bytes_per_s
    return 100.0 * least / seconds
