"""Sampler-state snapshot and resume (port of nshmc_tpu/utils/checkpointing.py).

A snapshot holds every field of a chain state (a dataclass or a dict of
tensors, saved on the CPU) and the states of the generators that draw the
chains' momenta and accept uniforms, each a uint8 tensor: the JAX chain
state carries its PRNG keys, the port's draws come from `torch.Generator`s,
so a resumed run draws what an uninterrupted one would. The file is written
under a temporary name and then renamed over the old one, so a run killed
mid-write keeps its previous snapshot. JAX snapshots are not read.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import torch


def _snapshot_path(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}.pt")


def _tensors(state: Any) -> dict:
    if isinstance(state, dict):
        return dict(state)
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def save_chain_state(path: str, state: Any, step: int = 0,
                     generators: Sequence[torch.Generator] = ()) -> None:
    """Write a snapshot of `state` and of the `generators`' states to
    `path`/step_{step}.pt."""
    target = _snapshot_path(path, step)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    snapshot = {"state": {k: v.detach().cpu() for k, v in _tensors(state).items()},
                "generators": [g.get_state() for g in generators]}
    tmp = f"{target}.tmp{os.getpid()}"
    torch.save(snapshot, tmp)
    os.replace(tmp, target)


def load_chain_state(path: str, template: Any, step: int = 0,
                     generators: Sequence[torch.Generator] = ()) -> Optional[Any]:
    """The snapshot at `path`/step_{step}.pt as an object of `template`'s
    type, each tensor on its template field's device and in its dtype, or
    None when there is none. Sets the `generators`' states to the saved
    ones (none given: the saved ones are not read)."""
    target = _snapshot_path(path, step)
    if not os.path.exists(target):
        return None
    snapshot = torch.load(target, map_location="cpu", weights_only=True)
    fields = _tensors(template)
    if set(snapshot["state"]) != set(fields):
        raise ValueError(f"snapshot {target} holds {sorted(snapshot['state'])}, "
                         f"not the fields {sorted(fields)}")
    if generators and len(snapshot["generators"]) != len(generators):
        raise ValueError(f"snapshot {target} holds {len(snapshot['generators'])} generator "
                         f"states for {len(generators)} generators")
    for g, s in zip(generators, snapshot["generators"]):
        g.set_state(s)
    restored = {k: v.to(device=fields[k].device, dtype=fields[k].dtype)
                for k, v in snapshot["state"].items()}
    return restored if isinstance(template, dict) else type(template)(**restored)
