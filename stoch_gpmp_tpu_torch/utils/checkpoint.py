"""Planner checkpoint and resume.

PyTorch counterpart of ``stoch_gpmp_tpu/utils/checkpoint.py``. A planner
state (``StochGPMPState`` / ``GPMPState``: tensors and a
``torch.Generator``) goes to one file through ``torch.save``: each tensor on
the CPU, and the generator's state in place of the JAX key, so a resumed
planner draws the stream the saved one would have drawn.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass, replace

import torch


def save_planner_state(path: str, state) -> None:
    """Save a dataclass planner state to ``path``."""
    out = {}
    for f in fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Generator):
            out[f.name] = {"generator_state": v.get_state(), "device": str(v.device)}
        elif torch.is_tensor(v):
            out[f.name] = v.detach().cpu()
        else:
            out[f.name] = v
    torch.save(out, path)


def load_planner_state(path: str, like):
    """Load a state saved by ``save_planner_state``; ``like`` gives the
    dataclass and the devices (e.g. the current planner state). Its
    generator takes the saved generator state; its tensors are replaced."""
    if not is_dataclass(like):
        raise TypeError(f"like must be a planner state dataclass, got {type(like)}")
    data = torch.load(path, map_location="cpu", weights_only=True)
    new = {}
    for f in fields(like):
        cur, saved = getattr(like, f.name), data[f.name]
        if isinstance(cur, torch.Generator):
            gen = torch.Generator(device=cur.device)
            gen.set_state(saved["generator_state"])
            new[f.name] = gen
        elif torch.is_tensor(cur):
            new[f.name] = saved.to(device=cur.device, dtype=cur.dtype)
        else:
            new[f.name] = saved
    return replace(like, **new)
