"""The first stage's decode an evaluation: device milliseconds of the
kernels launched while the program's `kl.decode` span is open (the KL-f8
decoder's forward, eager), read through spans.py from the span's two CUDA
events (nshmc_tpu_torch.utils.profiling.device_ms: the stream's time from
the span's opening to its close, so an idle gap between its kernels would
count; none where the device runs behind the host), summed over the
profiled attempt and divided by its evaluations. Nothing from a program
without timed spans or with no `kl.decode` span."""
import spans

KERNELS = ()
SPAN = "kl.decode"


def read(ctx):
    try:
        from nshmc_tpu_torch.utils import profiling
    except ImportError:
        return None
    device_ms = getattr(profiling, "device_ms", None)
    found = spans.within(ctx.trace)
    if device_ms is None or not found:
        return None
    ms = [device_ms(s) for s in found if s.name == SPAN]
    if not ms or None in ms:
        return None
    return sum(ms) / ctx.evals
