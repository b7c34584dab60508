"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``csrc/`` holds the CUDA sources; :mod:`._build` compiles them with ``nvcc``
on first use. A wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors.
"""
