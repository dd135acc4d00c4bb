"""Iteration timing and logging (reference ``stoch_gpmp/planner.py:664-672``)."""

from __future__ import annotations

import time
from contextlib import contextmanager


def elapsed_time(t: float) -> float:
    return time.time() - t


def print_info(iteration, max_iterations, start_time_iter, start_time, costs):
    """Format-parity iteration log line (reference ``planner.py:668-672``);
    ``costs`` is a tensor on any device or an array."""
    import torch

    mean_cost = float(torch.as_tensor(costs).sum(-1).mean())
    print(
        f"Iteration: {iteration:5}/{max_iterations:5} "
        f"| Iter Time: {elapsed_time(start_time_iter):.3f}"
        f"| Total Time: {elapsed_time(start_time):.3f} "
        f"| Cost: {mean_cost:.6f}"
    )


class Timer:
    """Wall-clock phase timer with named laps. Device work is asynchronous:
    synchronize the device inside a lap that times it."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._start = time.perf_counter()

    @contextmanager
    def lap(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.laps[name] = self.laps.get(name, 0.0) + time.perf_counter() - t0

    def total(self) -> float:
        return time.perf_counter() - self._start
