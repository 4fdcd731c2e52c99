"""Host synchronisations of the sampler an MH attempt: the program's
`hmc.sync` spans in the profiled attempt's window over its `hmc.attempt`
spans (spans.py)."""
import spans

KERNELS = ()


def read(ctx):
    return spans.syncs_per_attempt(ctx.trace)
