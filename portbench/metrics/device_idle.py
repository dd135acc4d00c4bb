"""Share of the window's wall time per iteration in which no operation ran
on the device, %: the device's busy time per iteration in the traced
window (``torch.profiler``) over the untraced window's wall time per
iteration. The traced window's own wall time carries the profiler's host
cost (the demo's build span takes ~2.4x as long under it), so it is not
the denominator."""


def read(ctx):
    tr, w = ctx["trace"], ctx["window"]
    if not tr or not tr["ops"] or not tr["iters"] or not w["updates"]:
        return None
    wall_per_iter = w["seconds"] * ctx["problem"].num_particles / w["updates"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["iters"] / wall_per_iter)
