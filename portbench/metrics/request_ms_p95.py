"""The 95th percentile of every request's latency in the window, issue to
result on the host, in ms (failed requests included)."""

from portbench.harness import percentile


def read(ctx):
    lat = ctx["window"]["latencies"]
    return 1e3 * percentile(lat, 95) if lat else None
