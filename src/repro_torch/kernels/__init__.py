"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``csrc/`` holds the CUDA sources; :mod:`._build` compiles them with ``nvcc``
on first use. A wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors.
"""
import torch

# the input dtypes of the compute kernels (LIF, spike matmul, flash
# attention), as the reference's Pallas kernels take them
FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def working_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The dtype a compute kernel runs in for these inputs: bfloat16 when
    every input is bfloat16, float32 otherwise (mixed inputs, or float16,
    which the kernels do not take). Casting up to float32 is exact."""
    return (torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in tensors)
            else torch.float32)
