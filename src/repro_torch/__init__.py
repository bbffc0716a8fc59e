"""PyTorch/CUDA port of the MoEless serving system (``repro``, the JAX
reference). Plain tensor code is PyTorch; every TPU kernel on the
ported path is a hand-written CUDA kernel for Hopper (``kernels/csrc``).
This package imports neither JAX nor anything of ``repro``."""
