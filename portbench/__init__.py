"""The benchmark of ``distdiff_tpu_torch`` on one or four NVIDIA GPUs: one
command (``portbench/run.py``) runs one cell of ``BENCHMARK.json``."""
