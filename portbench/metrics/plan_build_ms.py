"""Mean host time of the benchmark's ``build`` span per plan in the window:
the scene, the cost stack and ``StochGPMP.__init__`` (its two priors and
the initial draw), ms."""


def read(ctx):
    b = ctx["spans"].get("build")
    return 1e3 * sum(b) / len(b) if b else None
