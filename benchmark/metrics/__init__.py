"""Per-layer metrics, one module each, found by the metric's name in
``BENCHMARK.json``.  Each ``read(trace)`` takes the traced window
(``benchmark.trace.Trace``) and returns the metric's value, or None when
the window has nothing for it to read (it is then left out of the line)."""
