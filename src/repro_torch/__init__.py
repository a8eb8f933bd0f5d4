"""repro_torch — the PyTorch/CUDA port of the BSQ serving system.

A package of its own beside the JAX package ``repro``, which stays the
reference it is tested against.  It imports ``torch``, ``numpy`` and
the stdlib, never JAX and nothing of ``repro``.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.  The packed matmul
runs through a hand-written Hopper kernel (``kernels/csrc``), built with
nvcc at its first launch.
"""
