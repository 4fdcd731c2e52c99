"""Forward replays of the DDIM decoder's CUDA graphs an evaluation: the
program's `ddim.replay` spans in the profiled attempt's window over its
`hmc.forward` spans (spans.py). 1.0 where every evaluation's ladder ran as
a graph, 0 where each ran eagerly; nothing from a program whose decoder has
no graphs (no nshmc_tpu_torch.sampling.graphs with that span) or that
recorded no spans."""
import spans

KERNELS = ()
SPAN = "ddim.replay"


def read(ctx):
    try:
        from nshmc_tpu_torch.sampling import graphs
    except ImportError:
        return None
    if getattr(graphs, "REPLAY_SPAN", None) != SPAN:
        return None
    found = spans.within(ctx.trace)
    evals = sum(s.name == "hmc.forward" for s in found) if found else 0
    if not evals:
        return None
    return sum(s.name == SPAN for s in found) / evals
