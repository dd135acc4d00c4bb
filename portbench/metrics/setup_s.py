"""Seconds from the process's start to the first timed request: imports,
the problem's build, the kernels' build where the checkout has none yet,
and the warm-up requests. A run that built the kernels says so in the
result's ``setup`` object (``compiled``, ``kernel_build_s``), so a first
run in a checkout is recorded apart."""


def read(ctx):
    return ctx["setup_s"]
