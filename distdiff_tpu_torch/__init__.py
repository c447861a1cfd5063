"""PyTorch/CUDA port of ``distdiff_tpu``: guided dataset expansion on an
NVIDIA Hopper card.

The JAX package beside this one is the reference; module paths mirror it.
Plain tensor code is PyTorch; the Pallas flash-attention kernels of the
reference are hand-written CUDA kernels (``csrc/``), bound with ``ctypes``
and built from source at first use (``ops/_build.py``).
"""
