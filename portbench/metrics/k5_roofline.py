"""The fused dof Panda iteration kernel (K5, ``csrc/fused_panda_dof_step.cu``)
against its roofline, %: the least time for one iteration's work
(``counts/panda.py``: ``W_dof``'s non-zero half and no other structural
zero, at the FP32 peak and the HBM bandwidth of ``counts/peaks.py``) over
the kernel's mean device time per launch in the traced window. Nothing to
read where the kernel did not run."""

from portbench.counts import peaks
from portbench.harness import load_module

KERNEL = "fused_panda_dof_step_kernel"


def read(ctx):
    tr, cfg, plan = ctx["trace"], ctx["cfg"], ctx["plan"]
    if not tr or plan is None:
        return None
    durs = [d for name, _, d in tr["ops"] if KERNEL in name]
    if not durs:
        return None
    work = load_module("counts", cfg["problem"]).iteration_of(cfg, plan)
    mean_s = 1e-6 * sum(durs) / len(durs)
    return 100.0 * peaks.least_seconds(work["flops"], work["bytes"]) / mean_s
