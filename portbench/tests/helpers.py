"""Shared pieces of the benchmark's tests."""

import torch

from portbench import harness


def config(name: str = "planar-env") -> dict:
    return harness.load_json("configs", name)


def obstacles_of(prims) -> list:
    """The program's obstacle objects as the benchmark's tuples."""
    out = []
    for o in prims:
        if type(o).__name__ == "ObstacleRectangle":
            out.append(("rect", o.center_x, o.center_y, o.width, o.height))
        else:
            out.append(("circle", o.center_x, o.center_y, o.radius))
    return out


def run(cell: str, seed: int, seconds: float, device, monkeypatch=None, **traffic):
    """One run of ``cell`` in this process, with ``traffic`` keys overriding
    the traffic file's (the look for a card is the CLI's, not this)."""
    if monkeypatch is not None and traffic:
        load = harness.load_json

        def patched(kind, name):
            data = load(kind, name)
            return {**data, **traffic} if kind == "traffic" else data

        monkeypatch.setattr(harness, "load_json", patched)
    import time

    return harness.run_cell(cell, seed, seconds, False, torch.device(device),
                            time.perf_counter())
