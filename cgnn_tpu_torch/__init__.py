"""cgnn_tpu_torch: the PyTorch/CUDA port of cgnn_tpu for NVIDIA Hopper.

Each module maps onto the JAX package module of the same path (the
reference it is tested against). Entry points take an explicit ``device``
and default to CUDA; the hand-written kernels live under ``ops/csrc`` and
build with nvcc on first use (ops/_build.py).
"""
