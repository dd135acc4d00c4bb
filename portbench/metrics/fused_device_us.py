"""The fused loop's device pace, us per launch: the CUDA-event time of
the window's ``planner.fused_loop`` spans (two events on the stream at
the span's ends, no profiler) over their launches. Nothing to read off
the card."""

from portbench.program_spans import named, window_spans


def read(ctx):
    loops = [s for s in named(window_spans(ctx) or [], "planner.fused_loop")
             if s.device_ms is not None]
    launches = sum(s.n for s in loops)
    return 1e3 * sum(s.device_ms for s in loops) / launches if launches else None
