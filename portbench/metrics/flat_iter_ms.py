"""The flat route's host time, ms per iteration: the window's
``planner.flat`` spans over their iterations (``n``); on the fused
planner, the last iteration of every call."""

from portbench.program_spans import named, window_spans


def read(ctx):
    flat = named(window_spans(ctx) or [], "planner.flat")
    iters = sum(s.n for s in flat)
    return sum(s.ms for s in flat) / iters if iters else None
