"""The host's launch pace in the fused loop, us per launch: the host time
of the window's ``planner.fused_loop`` spans over their launches (``n``,
one a fused iteration)."""

from portbench.program_spans import named, window_spans


def read(ctx):
    loops = named(window_spans(ctx) or [], "planner.fused_loop")
    launches = sum(s.n for s in loops)
    return 1e3 * sum(s.ms for s in loops) / launches if launches else None
