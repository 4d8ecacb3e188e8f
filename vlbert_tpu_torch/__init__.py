"""PyTorch + CUDA port of vlbert_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``engine/``,
``training/``) with the same module and class names. Plain tensor code is
PyTorch; ROIAlign and the attention core run through hand-written CUDA
kernels in ``csrc/``, built with ``nvcc`` on first use
(``kernels/build.py``). Each kernel wrapper takes its plain PyTorch version
only for tensors that lie on the CPU.

This package imports torch and never jax.
"""
