"""Fused LIF membrane update: the CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by device.

Per neuron and timestep, with float32 math and both results in the input
dtype::

    u' = ((decay * u) * (1 - s)) + I          (hard reset)
    u' = ((decay * u) - (threshold * s)) + I  (soft reset)
    s' = (u' > threshold)

The kernel (``csrc/lif.cu``) replaces the reference's Pallas kernel
``repro/kernels/lif.py::lif_step_pallas``; its source note gives the design,
the bound and why it is bit-identical to :func:`lif_step_plain`. A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import FLOATS, _build, working_dtype

KERNEL = "lif"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lif_step_plain(u: torch.Tensor, s_prev: torch.Tensor,
                   current: torch.Tensor, *, threshold: float = 1.0,
                   decay: float = 0.5, reset: str = "hard"):
    """Plain version, one float32 operation after another in the
    reference's order (``repro.kernels.ref.lif_ref``). Returns
    ``(u', s')`` in ``u.dtype``."""
    u32, s32, c32 = u.float(), s_prev.float(), current.float()
    if reset == "hard":
        u_new = decay * u32 * (1.0 - s32) + c32
    elif reset == "soft":
        u_new = decay * u32 - threshold * s32 + c32
    else:
        raise ValueError(f"unknown reset {reset!r}")
    s_new = (u_new > threshold).to(u.dtype)
    return u_new.to(u.dtype), s_new


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_lif_step
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def lif_step_kernel(u: torch.Tensor, s_prev: torch.Tensor,
                    current: torch.Tensor, *, threshold: float = 1.0,
                    decay: float = 0.5, reset: str = "hard"):
    """One fused LIF update of same-shaped, contiguous tensors of any shape,
    each float32, bfloat16 or float16. Returns ``(u', s')`` in ``u.dtype``,
    as the reference does. The kernel runs in bfloat16 storage when every
    input is bfloat16 and in float32 otherwise (inputs cast up exactly,
    results rounded once to ``u.dtype``); its math is float32 either way.
    CPU tensors take the plain version."""
    tensors = (u, s_prev, current)
    if reset not in ("hard", "soft"):
        raise ValueError(f"unknown reset {reset!r}")
    if all(t.device.type == "cpu" for t in tensors):
        return lif_step_plain(u, s_prev, current, threshold=threshold,
                              decay=decay, reset=reset)
    dev = u.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("lif_step_kernel: u, s_prev and current must be on "
                         "one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype not in FLOATS for t in tensors):
        raise TypeError("lif_step_kernel: u, s_prev and current must be "
                        "float32, bfloat16 or float16, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.shape != u.shape for t in tensors):
        raise ValueError("lif_step_kernel: u, s_prev and current must have "
                         f"one shape, got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lif_step_kernel: every input must be contiguous")
    work = working_dtype(*tensors)
    uw, sw, cw = (t.to(work) for t in tensors)
    u_new = torch.empty_like(uw)
    s_new = torch.empty_like(uw)
    if u.numel() == 0:
        return u_new.to(u.dtype), s_new.to(u.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(uw.data_ptr(), sw.data_ptr(), cw.data_ptr(),
                u_new.data_ptr(), s_new.data_ptr(), u.numel(),
                float(threshold), float(decay), int(reset == "hard"),
                _DTYPES[work], dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"lif kernel launch failed: CUDA error {rc}")
    lif_step_kernel.launches += 1
    return u_new.to(u.dtype), s_new.to(u.dtype)


lif_step_kernel.launches = 0
