"""K1, the attention kernel (csrc/attention.cu), at the self-attention of a
conditional U-Net's SpatialTransformers: the least time its calls in the
profiled attempt need (attn_sites.py: q, k, v read and the output written
once over the HBM rate, or q k^T and the weights times v over the
configuration's peak, whichever is larger) over the device time of its
kernels. Nothing to read where the program recorded no sites, or where
K1's launch counter moved over the profiled attempt by other than its
evaluations times the sites the hooks found."""
import attn_sites

KERNELS = ("attn_fwd_tc_kernel", "attn_fwd_f32_kernel")


def read(ctx):
    log = attn_sites.LOG
    if not (log.found and ctx.hbm_bytes_per_s and ctx.peak_flops_per_s):
        return None
    if log.launches_within(ctx.trace.t0, ctx.trace.t1) != ctx.evals * len(log.found):
        return None
    seconds = ctx.trace.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    least = ctx.evals * sum(c.least_s(ctx.hbm_bytes_per_s, ctx.peak_flops_per_s)
                            for c in log.found)
    return 100.0 * least / seconds
