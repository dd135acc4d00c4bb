"""The dof route's host time, ms per iteration: the window's
``planner.dof`` spans over their iterations (``n``); on the fused Panda
planner, the last iteration of every call."""

from portbench.program_spans import named, window_spans


def read(ctx):
    dof = named(window_spans(ctx) or [], "planner.dof")
    iters = sum(s.n for s in dof)
    return sum(s.ms for s in dof) / iters if iters else None
