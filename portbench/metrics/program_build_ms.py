"""The program's part of a plan's build, ms per plan in the window: the
root spans ``envs.obstacle_map``, ``costs.raster_field``,
``costs.quadratic`` and ``planner.init`` (the priors, the initial draw),
over the plans (``planner.init`` spans). The rest of the benchmark's
``build`` span is its own scene draw."""

from portbench.program_spans import PREFIX, named, window_spans

ROOTS = {PREFIX + n for n in ("envs.obstacle_map", "costs.raster_field", "costs.quadratic",
                              "planner.init")}


def read(ctx):
    spans = window_spans(ctx) or []
    plans = len(named(spans, "planner.init"))
    if not plans:
        return None
    return sum(s.ms for s in spans if s.parent < 0 and s.name in ROOTS) / plans
