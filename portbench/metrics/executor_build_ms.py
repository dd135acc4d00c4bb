"""The fused executor's build, ms: the mean ``planner.fused_build`` span
in the window (the first ``optimize`` of every new planner builds it)."""

from portbench.program_spans import named, window_spans


def read(ctx):
    builds = named(window_spans(ctx) or [], "planner.fused_build")
    return sum(s.ms for s in builds) / len(builds) if builds else None
