"""Device operations (kernels, copies, memsets) in the traced window per
planner iteration (``torch.profiler``)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["ops"] or not tr["iters"]:
        return None
    return len(tr["ops"]) / tr["iters"]
