"""Fused LIF membrane update and its backward: the CUDA kernels, their plain
PyTorch versions, and the wrappers that pick between them by device.

Per neuron and timestep, with float32 math and both results in the input
dtype::

    u' = ((decay * u) * (1 - s)) + I          (hard reset)
    u' = ((decay * u) - (threshold * s)) + I  (soft reset)
    s' = (u' > threshold)

and, given the cotangents ``g_u`` of u' and ``g_s`` of s' (either may be
absent), the cotangent ``g`` of u' (which is also that of I) and, where asked
for, those of u and s (:func:`lif_backward_plain` spells out the order)::

    g   = g_u + g_s * surrogate(u' - threshold)
    d_u = decay * (g * (1 - s))   or  decay * g          (hard / soft)
    d_s = -(g * (decay * u))      or  -(threshold * g)

The kernels (``csrc/lif.cu``) replace the reference's Pallas kernel
``repro/kernels/lif.py::lif_step_pallas`` and the torch operations of the
port's backward; the source note gives the design, the bound and what is bit
for bit the plain version. A CUDA tensor launches a kernel (or raises); a CPU
tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import FLOATS, _build, working_dtype

KERNEL = "lif"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RESETS = ("hard", "soft")
SURROGATES = ("rect", "sigmoid", "atan")


def _stream(dev: torch.device) -> int:
    """The current stream of ``dev`` as a ``cudaStream_t`` int, without
    building a ``torch.cuda.Stream`` object (a few microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


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


_FNS: dict = {}


def _fn(name: str, argtypes):
    """The library's C function ``name``, typed on first use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(KERNEL), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[name] = fn
    return fn


_STEP_ARGS = [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BACKWARD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [
    ctypes.c_float] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def lif_step_kernel(u: torch.Tensor, s_prev: torch.Tensor,
                    current: torch.Tensor, *, threshold: float = 1.0,
                    decay: float = 0.5, reset: str = "hard"):
    """One fused LIF update of same-shaped, contiguous tensors of any shape,
    each float32, bfloat16 or float16. Returns ``(u', s')`` in ``u.dtype``,
    as the reference does. The kernel runs in bfloat16 storage when every
    input is bfloat16 and in float32 otherwise (inputs cast up exactly,
    results rounded once to ``u.dtype``); its math is float32 either way.
    CPU tensors take the plain version."""
    if reset not in _RESETS:
        raise ValueError(f"unknown reset {reset!r}")
    dev = u.device
    if (dev.type == "cpu" and s_prev.device.type == "cpu"
            and current.device.type == "cpu"):
        return lif_step_plain(u, s_prev, current, threshold=threshold,
                              decay=decay, reset=reset)
    tensors = (u, s_prev, current)
    if dev.type != "cuda" or s_prev.device != dev or current.device != dev:
        raise ValueError("lif_step_kernel: u, s_prev and current must be on "
                         "one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype not in FLOATS for t in tensors):
        raise TypeError("lif_step_kernel: u, s_prev and current must be "
                        "float32, bfloat16 or float16, got "
                        f"{[t.dtype for t in tensors]}")
    if s_prev.shape != u.shape or current.shape != u.shape:
        raise ValueError("lif_step_kernel: u, s_prev and current must have "
                         f"one shape, got {[tuple(t.shape) for t in tensors]}")
    if not (u.is_contiguous() and s_prev.is_contiguous()
            and current.is_contiguous()):
        raise ValueError("lif_step_kernel: every input must be contiguous")
    work = working_dtype(*tensors)
    uw, sw, cw = (_as(t, work) for t in tensors)
    u_new = torch.empty_like(uw)
    s_new = torch.empty_like(uw)
    if u.numel():
        rc = _fn("repro_lif_step", _STEP_ARGS)(
            uw.data_ptr(), sw.data_ptr(), cw.data_ptr(), u_new.data_ptr(),
            s_new.data_ptr(), u.numel(), threshold, decay, reset == "hard",
            _DTYPES[work], dev.index, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"lif kernel launch failed: CUDA error {rc}")
        lif_step_kernel.launches += 1
    return _as(u_new, u.dtype), _as(s_new, u.dtype)


lif_step_kernel.launches = 0


def surrogate_grad(u_minus_th, kind: str, alpha: float):
    """d spike / d(u - θ) of the surrogate ``kind`` at ``u_minus_th``."""
    if kind == "rect":
        # STBP rectangular window: 1/alpha inside |u-θ| < alpha/2
        return (u_minus_th.abs() < (alpha / 2)).to(u_minus_th.dtype) / alpha
    if kind == "sigmoid":
        s = torch.sigmoid(alpha * u_minus_th)
        return alpha * s * (1 - s)
    if kind == "atan":
        return alpha / (2 * (1 + (math.pi / 2 * alpha * u_minus_th) ** 2))
    raise ValueError(f"unknown surrogate {kind}")


def lif_backward_plain(g_u, g_s, u, s_prev, u_new, *, threshold: float = 1.0,
                       decay: float = 0.5, reset: str = "hard",
                       surrogate: str = "rect", alpha: float = 2.0,
                       need_u: bool = True, need_s: bool = True):
    """Plain version of the backward of one LIF update, torch operation by
    torch operation: the cotangents ``(d_u, d_s, g)`` of u, s_prev and I (g
    is also the total cotangent of u') from ``g_u`` of u' and ``g_s`` of s',
    either of which may be None. ``d_u`` / ``d_s`` are None unless
    ``need_u`` / ``need_s``; all three are None when both cotangents are.
    Like the reference's autodiff, it differentiates through ``s_prev`` as
    well as ``u``."""
    if reset not in _RESETS:
        raise ValueError(f"unknown reset {reset!r}")
    # total cotangent of u': its own plus the spike's through the
    # surrogate of spike(u' - θ)
    g = g_u
    if g_s is not None:
        g_spike = g_s * surrogate_grad(u_new - threshold, surrogate, alpha)
        g = g_spike if g is None else g + g_spike
    if g is None:
        return None, None, None
    # the reference's autodiff order: u' = ((λ·u)·(1 - s)) + I or
    # ((λ·u) - θ·s) + I
    d_u = d_s = None
    if reset == "hard":
        if need_u:
            d_u = decay * (g * (1.0 - s_prev))
        if need_s:
            d_s = -(g * (decay * u))
    else:
        if need_u:
            d_u = decay * g
        if need_s:
            d_s = -(threshold * g)
    return d_u, d_s, g


def lif_backward_kernel(g_u, g_s, u, s_prev, u_new, *,
                        threshold: float = 1.0, decay: float = 0.5,
                        reset: str = "hard", surrogate: str = "rect",
                        alpha: float = 2.0, need_u: bool = True,
                        need_s: bool = True):
    """The backward of one LIF update in one launch: :func:`lif_backward_plain`
    on same-shaped, contiguous tensors (the cotangents present and u, s_prev,
    u_new), each float32, bfloat16 or float16. The kernel runs in bfloat16
    storage when every tensor is bfloat16 and in float32 otherwise; the
    results are in the tensors' promoted dtype. With ``g_s`` None, ``g`` is
    ``g_u`` itself and nothing is launched unless ``d_u`` or ``d_s`` is
    asked for. CPU tensors take the plain version."""
    if reset not in _RESETS:
        raise ValueError(f"unknown reset {reset!r}")
    if surrogate not in SURROGATES:
        raise ValueError(f"unknown surrogate {surrogate}")
    tensors = [t for t in (g_u, g_s, u, s_prev, u_new) if t is not None]
    dev = u_new.device
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in tensors):
        return lif_backward_plain(
            g_u, g_s, u, s_prev, u_new, threshold=threshold, decay=decay,
            reset=reset, surrogate=surrogate, alpha=alpha, need_u=need_u,
            need_s=need_s)
    shape, out = u_new.shape, u_new.dtype
    for t in tensors:
        if dev.type != "cuda" or t.device != dev:
            raise ValueError("lif_backward_kernel: every tensor must be on "
                             "one CUDA device (or all on the CPU), got "
                             f"{[str(t.device) for t in tensors]}")
        if t.dtype not in FLOATS:
            raise TypeError("lif_backward_kernel: every tensor must be "
                            "float32, bfloat16 or float16, got "
                            f"{[t.dtype for t in tensors]}")
        if t.shape != shape:
            raise ValueError("lif_backward_kernel: every tensor must have "
                             "one shape, got "
                             f"{[tuple(t.shape) for t in tensors]}")
        if not t.is_contiguous():
            raise ValueError("lif_backward_kernel: every tensor must be "
                             "contiguous")
        if t.dtype != out:
            out = torch.promote_types(out, t.dtype)
    if g_u is None and g_s is None:
        return None, None, None
    if g_s is None and not (need_u or need_s):
        return None, None, _as(g_u, out)
    work = out if out in _DTYPES else working_dtype(*tensors)
    if work != out or any(t.dtype != work for t in tensors):
        g_u, g_s, u, s_prev, u_new = (None if t is None else _as(t, work)
                                      for t in (g_u, g_s, u, s_prev, u_new))
    d_u = torch.empty_like(u_new) if need_u else None
    d_s = torch.empty_like(u_new) if need_s else None
    g = torch.empty_like(u_new) if g_s is not None else None
    if u_new.numel():
        rc = _fn("repro_lif_backward", _BACKWARD_ARGS)(
            None if g_u is None else g_u.data_ptr(),
            None if g_s is None else g_s.data_ptr(), u.data_ptr(),
            s_prev.data_ptr(), u_new.data_ptr(),
            None if d_u is None else d_u.data_ptr(),
            None if d_s is None else d_s.data_ptr(),
            None if g is None else g.data_ptr(), u_new.numel(), threshold,
            decay, alpha / 2, alpha, math.pi / 2 * alpha, reset == "hard",
            SURROGATES.index(surrogate), _DTYPES[work], dev.index,
            _stream(dev))
        if rc != 0:
            raise RuntimeError(f"lif backward kernel launch failed: CUDA "
                               f"error {rc}")
        lif_backward_kernel.launches += 1
    if g is None:
        g = g_u
    if work == out:
        return d_u, d_s, g
    return tuple(None if t is None else t.to(out) for t in (d_u, d_s, g))


lif_backward_kernel.launches = 0
