"""The GP priors' build, ms per plan in the window: every ``gp.prior``
span (``make_gp_prior``, two a ``StochGPMP``) over the plans
(``planner.init`` spans)."""

from portbench.program_spans import named, window_spans


def read(ctx):
    spans = window_spans(ctx) or []
    plans = len(named(spans, "planner.init"))
    if not plans:
        return None
    return sum(s.ms for s in named(spans, "gp.prior")) / plans
