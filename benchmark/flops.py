"""Useful FLOPs of one evaluation, counted once on the `meta` device over the
plain reference (a frozen copy of nshmc_tpu_torch/utils/profiling.py::
compiled_flops): each aten op that torch.utils.flop_counter has a formula
for adds its count (2 per multiply-add of every matmul and convolution,
forward and the backward the input gradient needs; frozen weights take no
weight gradient). The reference keeps every activation, so activation
checkpointing's recompute is not counted."""
from __future__ import annotations

import torch


def count(fn, *args) -> float:
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out

    with Count() as c:
        fn(*args)
    return float(c.total)


def per_eval(problem_cls, config: dict, traffic: dict, x_shape) -> float:
    """FLOPs of one energy + input gradient of the cell's whole batch."""
    import numpy as np

    from reference import operators

    meta = torch.device("meta")
    op = operators.build(traffic, config["data"], np.random.default_rng(0), meta)
    problem = problem_cls(config, traffic, op, meta)
    problem.chunk = traffic["chains"]
    x = torch.zeros((traffic["chains"],) + tuple(x_shape), device=meta)
    y0 = torch.zeros(op.d_y, device=meta)
    return count(problem.value_and_grad, x, y0)
