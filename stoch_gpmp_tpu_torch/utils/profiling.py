"""Profiling hooks: ``torch.profiler`` traces with named regions.

PyTorch counterpart of ``stoch_gpmp_tpu/utils/profiling.py`` (there
``jax.profiler``): ``trace`` records the host and, on a CUDA card, the
device's kernels into a Chrome trace viewable in Perfetto or
``chrome://tracing``; ``annotate`` names a region inside it.
"""

from __future__ import annotations

import os
from contextlib import contextmanager


@contextmanager
def trace(log_dir: str):
    """Record a profile of the block into ``log_dir/trace.json``:

    >>> with trace("/tmp/profile"):
    ...     planner.optimize(opt_iters=100)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextmanager
def annotate(name: str):
    """A named region inside a trace (a ``record_function`` range)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
