"""The program's own spans (``stoch_gpmp_tpu_torch.utils.profiling``) in
the untraced window, for the metrics that read them: the records that
started and ended inside ``[window.start, window.start + window.seconds]``
(the same ``time.perf_counter`` clock), so none of them pays the
profiler's host cost."""

PREFIX = "stoch_gpmp."


def window_spans(ctx):
    """The window's spans; None where the program keeps none (a build
    without the recorder), where the window holds none, or where the ring
    has dropped part of the window."""
    from stoch_gpmp_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    w = ctx["window"]
    return read(w["start"], w["start"] + w["seconds"]) or None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == PREFIX + name]
