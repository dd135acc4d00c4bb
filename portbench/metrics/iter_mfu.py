"""The whole iteration's share of the card's peak, %: the least time the
card could take for one iteration's work (``counts/<problem>.py``, the
larger of its operations at the FP32 peak and its bytes at the memory
peak) over the window's wall time per iteration."""

from portbench.counts import peaks
from portbench.harness import load_module


def read(ctx):
    w, cfg = ctx["window"], ctx["cfg"]
    plan = ctx["plan"]
    if not w["updates"] or plan is None:
        return None
    work = load_module("counts", cfg["problem"]).iteration_of(cfg, plan)
    iters = w["updates"] / ctx["problem"].num_particles
    return 100.0 * peaks.least_seconds(work["flops"], work["bytes"]) / (w["seconds"] / iters)
