"""The host time of the dof route's fields, ms per dof iteration: the
window's ``dof.fields`` spans (the stack's costs besides the quadratic:
the link fields, kernel K4, and the SE(3) goal) over the iterations of its
``planner.dof`` spans. Nothing to read from a program without the span."""

from portbench.program_spans import named, window_spans


def read(ctx):
    spans = window_spans(ctx) or []
    fields = named(spans, "dof.fields")
    iters = sum(s.n for s in named(spans, "planner.dof"))
    return sum(s.ms for s in fields) / iters if fields and iters else None
