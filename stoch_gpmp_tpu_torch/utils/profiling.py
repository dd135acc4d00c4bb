"""Profiling hooks: ``torch.profiler`` traces, the program's spans and its
counters.

PyTorch counterpart of ``stoch_gpmp_tpu/utils/profiling.py`` (there
``jax.profiler``): ``trace`` records the host and, on a CUDA card, the
device's kernels into a Chrome trace viewable in Perfetto or
``chrome://tracing``.

``annotate(name)`` is the program's span: every entry writes one record
into a fixed-size ring (name under ``stoch_gpmp.``, start and end on
``time.perf_counter_ns()``, its parent and root span, a work count ``n``,
and with ``device=True`` the device time between two CUDA events on the
current stream), whether or not a profiler runs. While ``torch.profiler``
records, the span also opens a ``record_function`` of the same name, so
the trace puts each kernel under the span that launched it. ``spans``
reads the ring over a stretch of that clock; ``counters`` snapshots the
planner's iterations per route, its fused-executor builds and the kernel
wrappers' launch counters.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from contextlib import ContextDecorator, contextmanager
from typing import NamedTuple

import torch
import torch.autograd.profiler as _torch_profiler

PREFIX = "stoch_gpmp."
CAPACITY = 1 << 17  # records kept: a 51-s demo window writes ~50,000
EVENT_PAIRS = 32  # CUDA event pairs in flight at most; a span past them keeps no device time
ROUTES = ("fused", "flat", "dof", "planes")
LAUNCH_COUNTERS = ("launches", "generic_launches", "staged_launches")


@contextmanager
def trace(log_dir: str):
    """Record a profile of the block into ``log_dir/trace.json``:

    >>> with trace("/tmp/profile"):
    ...     planner.optimize(opt_iters=100)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Span(NamedTuple):
    """One record of the ring. ``index`` counts every span the process
    opened; ``parent`` is the enclosing span's index (-1 for a root) and
    ``root`` the outermost one's (the request's id); ``device_ms`` is the
    CUDA-event time of a ``device=True`` span, else None."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    n: int | None
    device_ms: float | None

    @property
    def ms(self) -> float:
        return 1e-6 * (self.end_ns - self.start_ns)


class _Ring:
    """A preallocated list of records, each a ``Span``'s fields as a plain
    tuple, written once when its span closes into the slot after the last
    one written, until ``capacity`` later records take that slot."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.ids = itertools.count()  # span indices, taken when a span opens
        self.writes = itertools.count()  # slots, taken when a span closes
        self.records: list = [None] * capacity
        self.lost_ns = -1  # latest start among overwritten records (-1: none)
        self.pending: list = []  # (slot, index, start event, end event) not yet read
        self.free: list = []  # event pairs to reuse
        self.pairs = 0  # event pairs made


_ring = _Ring(CAPACITY)
_local = threading.local()
_now = time.perf_counter_ns
_streams: dict = {}
_counts = dict.fromkeys([f"iterations.{r}" for r in ROUTES] + ["executor_builds"], 0)


def _resolve(ring: _Ring, wait: bool) -> None:
    """Turn the pending event pairs into device times, oldest first, up to
    the first whose end has not passed (all of them with ``wait``), and
    return them to the pool."""
    done = 0
    for k, i, start, end in ring.pending:
        if wait:
            end.synchronize()
        try:  # elapsed_time queries both events and raises until they have passed
            ms = start.elapsed_time(end)
        except RuntimeError:
            break
        rec = ring.records[k]
        if rec[0] == i:
            ring.records[k] = rec[:-1] + (ms,)
        ring.free.append((start, end))
        done += 1
    del ring.pending[:done]


def _current_stream():
    """``torch.cuda.current_stream()`` without its per-call set-up: the
    ``Stream`` of the current device's current stream, made once per
    stream (``current_stream()`` took 40-57 us a call inside the planner's
    loop on an H100 host)."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                   device_type=key[2])
    return stream


class annotate(ContextDecorator):
    """A span named ``stoch_gpmp.<name>``, as a ``with`` block or a
    decorator; ``n`` is the work it holds (iterations, launches).
    ``device=True`` (on a CUDA path) also times it on the device between
    two CUDA events recorded on the stream current at its start; no call
    synchronises: the time is read when a later ``device=True`` span opens
    or when ``spans`` reads the ring."""

    def __init__(self, name: str, n: int | None = None, device: bool = False):
        self.name = PREFIX + name
        self.n = n
        self.device = device

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        i = next(_ring.ids)
        parent, root = (stack[-1][0], stack[-1][2]) if stack else (-1, i)
        rf = None
        if _torch_profiler._is_profiler_enabled:  # torch's own flag for a fast check
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        events = self._open_events() if self.device else None
        stack.append((i, parent, root, rf, events, _now()))
        return self

    @staticmethod
    def _open_events():
        """A pair from the pool (None past ``EVENT_PAIRS`` in flight), its
        start recorded on the current stream."""
        ring = _ring
        if ring.pending:
            _resolve(ring, False)
        if ring.free:
            start, end = ring.free.pop()
        elif ring.pairs < EVENT_PAIRS:
            ring.pairs += 1
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        else:
            return None
        stream = _current_stream()
        start.record(stream)
        return start, end, stream

    def __exit__(self, *exc):
        t1 = _now()
        i, parent, root, rf, events, t0 = _local.stack.pop()
        ring = _ring
        k = next(ring.writes) % ring.capacity
        old = ring.records[k]
        if old is not None and old[2] > ring.lost_ns:
            ring.lost_ns = old[2]
        ring.records[k] = (i, self.name, t0, t1, parent, root, self.n, None)
        if events is not None:
            start, end, stream = events
            end.record(stream)
            ring.pending.append((k, i, start, end))
        if rf is not None:
            rf.__exit__(None, None, None)
        return False


def spans(since_s: float | None = None, until_s: float | None = None) -> list[Span] | None:
    """The closed spans that started at or after ``since_s`` and ended by
    ``until_s`` (seconds of ``time.perf_counter()``, the same clock), in
    the order they opened; None where the ring has overwritten a record
    that started in that stretch. Waits for the device times still in
    flight."""
    ring = _ring
    _resolve(ring, True)
    lo = 0 if since_s is None else int(since_s * 1e9)
    hi = float("inf") if until_s is None else int(until_s * 1e9)
    if ring.lost_ns >= lo:
        return None
    return sorted(Span(*r) for r in ring.records if r is not None and r[2] >= lo and r[3] <= hi)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` (``iterations.<route>``,
    ``executor_builds``)."""
    _counts[name] += k


def counters() -> dict:
    """One snapshot: the planner's iterations per route (``fused``,
    ``flat``, ``dof``, ``planes``), its fused-executor builds, and each
    loaded kernel wrapper's own launch counters (``launches``, and where it
    keeps them ``generic_launches``, ``staged_launches``)."""
    launches = {}
    pkg = "stoch_gpmp_tpu_torch.ops.kernels."
    for name, mod in list(sys.modules.items()):
        if not name.startswith(pkg) or mod is None:
            continue
        for fn in vars(mod).values():
            if callable(fn) and getattr(fn, "__module__", None) == name and hasattr(fn, "launches"):
                launches[fn.__name__] = {c: getattr(fn, c) for c in LAUNCH_COUNTERS
                                         if hasattr(fn, c)}
    return {"iterations": {r: _counts[f"iterations.{r}"] for r in ROUTES},
            "executor_builds": _counts["executor_builds"],
            "launches": dict(sorted(launches.items()))}


def reset() -> None:
    """Empty the ring (``CAPACITY`` records) and zero the planner's
    counters; the kernel wrappers keep theirs."""
    global _ring
    _ring = _Ring(CAPACITY)
    for name in _counts:
        _counts[name] = 0
