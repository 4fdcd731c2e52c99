"""The DDIM ladder as two CUDA graphs (the decoder of ddim.py::make_decoder).

At the flagship's batch one energy+grad evaluation through the eager ladder
is ~4,100 kernel launches, each issued through Python modules and the
autograd engine, and the card waits on the host for most of them. A
`Decoder` replays the ladder as two CUDA graphs behind one autograd
Function, in the manner of `torch.cuda.make_graphed_callables`:

  - forward: x_T -> x_0, the network calls and the DDIM arithmetic;
  - backward: the cotangent of x_0 -> the gradient in x_T, activation
    checkpointing's recompute included.

The graphs hold the kernels the eager ladder launches (K1, K2a, K2b, K2c,
cuDNN, cuBLAS); what calls the decoder (the operator, the loss, autograd
through them, the sampler, a benchmark's wrapper) stays eager.

A call replays only where all of these hold, and runs the eager ladder
otherwise:
  - grad mode is on and x requires grad (the HMC oracle);
  - no forward or backward hook (or pre-hook) is registered on any module
    that the model reaches, and no global module hook: a replay fires none;
  - x is a CUDA tensor, no stream is being captured and no Python dispatch
    mode is active (utils/profiling.compiled_flops counts the ops it sees).
A replay runs what its capture found, so the graphs are keyed by x's
shape, dtype and device and the math flags that choose the kernels (cuDNN
on, deterministic, TF32, ...). A kernel wrapper put in another's place
after a capture goes unseen: a caller that swaps one calls `ladder`. A
key's first WARMUP calls run the eager ladder: they are the warm-up (they
fix cuDNN's algorithms, compile Triton's K2b, size K2a's and K2c's counter
buffers and pay every first-use cost once, as an eager evaluation does).
The next captures the graphs and replays them; they are captured again
where a parameter or buffer of the model no longer has the storage it had
(an in-place `load_state_dict` keeps it: the next replay reads the new
weights).

A decoder keeps the graphs of its KEEP most recently used keys (the chains'
waves and a smaller last wave, say), each in a memory pool of its own,
which other allocations cannot use, for as long as it lives or until
`release`; a new key evicts the oldest, whose pool goes before the new
capture. (Keys sharing one pool would hold about the largest key's memory,
but captures did not reuse each other's freed blocks: on an H100 a shared
pool grew by every key's capture.)

Each replay advances the launch counters of ops/ by what the captured call
launched (ops/launches.py); the capture itself leaves them as it found
them. The caller gets copies of x_0 and of the gradient, so a later replay
overwrites nothing that it holds; a backward whose forward replay was
overwritten by a later one replays that forward again. A forward replay is
the span `ddim.replay` (REPLAY_SPAN)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable
from torch.nn.modules import module as _module
from torch.utils import _python_dispatch

from ..ops import groupnorm, launches
from ..utils import profiling

REPLAY_SPAN = "ddim.replay"
WARMUP = 2  # a key's eager calls before its capture
KEEP = 2    # keys whose graphs a decoder keeps


def observe(module: torch.nn.Module) -> Optional[tuple]:
    """The data pointers of every parameter and buffer `module` reaches, or
    None where a hook that a replay would not fire is registered: on one of
    its modules, or globally."""
    if (_module._global_forward_hooks or _module._global_forward_pre_hooks
            or _module._global_backward_hooks or _module._global_backward_pre_hooks):
        return None
    ptrs = []
    for m in module.modules():
        if m._forward_hooks or m._forward_pre_hooks or m._backward_hooks \
                or m._backward_pre_hooks:
            return None
        ptrs += [t.data_ptr() for t in m._parameters.values() if t is not None]
        ptrs += [t.data_ptr() for t in m._buffers.values() if t is not None]
    return tuple(ptrs)


def _card(x: torch.Tensor) -> bool:
    """x is on the card, no stream is being captured and no Python dispatch
    mode watches the ops (a FLOP counter, say: a replay would hide them)."""
    return (x.device.type == "cuda" and not torch.cuda.is_current_stream_capturing()
            and _python_dispatch._get_current_dispatch_mode() is None)


def _flags() -> tuple:
    """The math flags that choose the kernels a capture records, beside x."""
    return (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, torch.are_deterministic_algorithms_enabled())


class Decoder:
    """decode(x_T) -> x_0: `ladder(x)` eagerly, or a replay of its graphs
    (see the module's doc). `module` is the network the ladder calls, whose
    hooks and weights the decoder observes; without one it never replays."""

    def __init__(self, ladder: Callable[[torch.Tensor], torch.Tensor],
                 module: Optional[torch.nn.Module]):
        self.ladder, self.module = ladder, module
        self.graphs = {}  # key -> _Graphs, least recently used first
        self.eager_calls = {}  # key -> the replayable calls it ran eagerly before a capture

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        weights = self.weights(x)
        if weights is None:
            return self.ladder(x)
        key = (tuple(x.shape), x.dtype, x.device) + _flags()
        graphs = self.graphs.pop(key, None)  # re-inserted last: the most recently used
        if graphs is None or graphs.weights != weights:
            warm = self.eager_calls.get(key, 0)
            if warm < WARMUP:  # the key's first calls are its warm-up
                self.eager_calls[key] = warm + 1
                return self.ladder(x)
            graphs = None  # its pool, and the oldest key's, go before the new capture
            while len(self.graphs) >= KEEP:
                self.graphs.pop(next(iter(self.graphs)))
            graphs = _Graphs(self.ladder, x, weights)
        self.graphs[key] = graphs
        with profiling.span(REPLAY_SPAN):
            return _Replay.apply(graphs, x)

    def release(self) -> None:
        """Drop every key's graphs and their pools (torch.cuda.empty_cache
        then returns the memory); the next calls warm up and capture anew."""
        self.graphs.clear()
        self.eager_calls.clear()

    def weights(self, x: torch.Tensor) -> Optional[tuple]:
        """`observe(module)` where a call with x replays; None where it runs
        the eager ladder."""
        if not (torch.is_grad_enabled() and x.requires_grad) or self.module is None:
            return None
        weights = observe(self.module)
        return weights if weights is not None and _card(x) else None


class _Graphs:
    """One key's two graphs, their static tensors, the counter buffers they
    launch with, and what each replay launches."""

    def __init__(self, ladder, x: torch.Tensor, weights: tuple):
        self.weights, self.replays = weights, 0
        before = launches.read()
        leaf = x.detach().clone().requires_grad_(True)
        self.x = leaf.detach()
        self.pins = groupnorm.counter_buffers(x.device)
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.device(x.device):  # captured on torch's side stream for captures
            pool = torch.cuda.graph_pool_handle()
            start = launches.read()
            with torch.cuda.graph(self.fwd, pool=pool):
                x0 = ladder(leaf)
            self.fwd_launches = launches.since(start)
            self.g = torch.empty_like(x0)
            start = launches.read()
            with torch.cuda.graph(self.bwd, pool=pool):
                (self.dx,) = torch.autograd.grad(_Cotangent.apply(x0, self.g), leaf)
            self.bwd_launches = launches.since(start)
        self.x0 = x0.detach()
        launches.advance({k: -n for k, n in launches.since(before).items()})

    def forward(self, x: torch.Tensor) -> int:
        """Replay the forward on x; returns the replay's number."""
        self.x.copy_(x)
        self.fwd.replay()
        launches.advance(self.fwd_launches)
        self.replays += 1
        return self.replays

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        """Replay the backward of the latest forward replay on g."""
        self.g.copy_(g)
        self.bwd.replay()
        launches.advance(self.bwd_launches)
        return self.dx.clone()


class _Cotangent(torch.autograd.Function):
    """A scalar whose backward hands x0 the cotangent g: the backward
    graph's root. (torch.autograd.grad given grad_outputs imports sympy the
    first time in a process, ~3.7 s of an H100 host's set-up; a scalar root
    needs none.)"""

    @staticmethod
    def forward(ctx, x0: torch.Tensor, g: torch.Tensor):
        ctx.g = g
        return x0.new_zeros(())

    @staticmethod
    @once_differentiable
    def backward(ctx, _):
        return ctx.g, None


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs: _Graphs, x: torch.Tensor):
        ctx.graphs, ctx.replay = graphs, graphs.forward(x)
        ctx.save_for_backward(x)
        return graphs.x0.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        graphs = ctx.graphs
        if graphs.replays != ctx.replay:  # a later forward replay holds the activations
            graphs.forward(*ctx.saved_tensors)
        return None, graphs.backward(g)
