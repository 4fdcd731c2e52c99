"""K2c, the GroupNorm+SiLU backward (csrc/groupnorm_bwd.cu, both designs):
the least time its calls in the profiled attempt need (x and g read once,
dx written once, over the card's HBM rate) over the device time of its
kernels. Nothing to read where no backward site ran or where the program's
own K2c counter disagrees with the sites the hooks found."""
KERNELS = ("gn_bwd_fused_kernel", "gn_bwd_partial_kernel", "gn_bwd_finish_kernel",
           "gn_bwd_dx_kernel")


def read(ctx):
    if not (ctx.sites_agree and ctx.sites.backward and ctx.hbm_bytes_per_s):
        return None
    seconds = ctx.trace.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    least = ctx.evals * ctx.sites.bwd_bytes / ctx.hbm_bytes_per_s
    return 100.0 * least / seconds
