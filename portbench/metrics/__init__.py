"""One reader per per-layer metric, found by the metric's name in
``BENCHMARK.json`` (``portbench/metrics/<name>.py``)."""
