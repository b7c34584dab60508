"""PyTorch/CUDA port of the SNN core-placement system.

Mirrors the JAX package's module paths (``repro.core.noc_batch`` ->
``repro_torch.core.noc_batch``). Imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""
