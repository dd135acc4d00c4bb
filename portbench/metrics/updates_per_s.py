"""Particle-trajectory updates per second: particles times iterations
completed in the window, over the window's seconds (host clock, from the
first request's issue to the last result on the host)."""


def read(ctx):
    w = ctx["window"]
    return w["updates"] / w["seconds"] if w["updates"] else None
