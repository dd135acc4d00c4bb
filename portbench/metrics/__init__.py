"""One reader per metric of ``BENCHMARK.json``, named as the metric:
``read(ctx)`` returns the value, or None where the run has nothing to read
(the harness then leaves the metric out). ``ctx`` holds the configuration
(``cfg``), the traffic (``traffic``), the closed-loop window (``window``:
latencies, updates, seconds), the set-up seconds (``setup_s``), the host
spans of the window (``spans``), the traced window (``trace``: device
operations, spans, iterations, busy and window seconds; None untraced),
the problem and the loop's plan."""
