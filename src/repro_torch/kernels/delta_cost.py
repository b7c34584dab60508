"""Per-chain O(degree) swap delta: the CUDA kernel, its plain PyTorch version,
and the wrapper that picks between them by device.

A pairwise swap of two placement slots only perturbs the edges incident to
the (at most two) moved nodes, so the comm-cost change of a proposed swap is

    delta[r] = sum_k vol[r, k] * (hops[src_a[r, k], dst_a[r, k]]
                                  - hops[src_b[r, k], dst_b[r, k]])

over the K incident-edge entries that
:func:`repro_torch.core.placement.device_search._swap_delta` gathers for each
chain ``r`` from :class:`repro_torch.core.noc_batch.IncidentTables` (padding
entries carry ``vol == 0``).

The kernel (``csrc/delta_cost.cu``) replaces the reference's Pallas kernel
``repro/kernels/delta_cost.py::delta_cost_pallas``; its source note gives the
design and the bound. The call contract is the reference's, without its TPU
padding of C and K. A CUDA tensor launches the kernel (or raises); a CPU
tensor takes :func:`delta_cost_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "delta_cost"


def delta_cost_plain(src_b: torch.Tensor, dst_b: torch.Tensor,
                     src_a: torch.Tensor, dst_a: torch.Tensor,
                     vol: torch.Tensor, hops: torch.Tensor) -> torch.Tensor:
    """Plain version: flat gathers from ``hops`` and a row sum. Float32
    ``[R]``."""
    C = hops.shape[0]
    flat = hops.reshape(-1).float()
    after = flat[src_a.long() * C + dst_a.long()]
    before = flat[src_b.long() * C + dst_b.long()]
    return (vol.float() * (after - before)).sum(dim=1)


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_delta_cost
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    return fn


def delta_cost(src_b: torch.Tensor, dst_b: torch.Tensor, src_a: torch.Tensor,
               dst_a: torch.Tensor, vol: torch.Tensor,
               hops: torch.Tensor) -> torch.Tensor:
    """Per-chain swap deltas, float32 ``[R]``.

    src_b/dst_b/src_a/dst_a [R, K] int32 core ids in ``[0, C)`` (before and
    after endpoints of each incident edge; padding may index any valid core),
    vol [R, K] float32 (0 on padding), hops [C, C] float32. CPU tensors take
    the plain version.
    """
    ids = (src_b, dst_b, src_a, dst_a)
    tensors = ids + (vol, hops)
    if all(t.device.type == "cpu" for t in tensors):
        return delta_cost_plain(*tensors)
    dev = src_b.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("delta_cost: every input must be on one CUDA device "
                         "(or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.int32 for t in ids) or \
            vol.dtype != torch.float32 or hops.dtype != torch.float32:
        raise TypeError("delta_cost: ids must be int32, vol and hops float32, "
                        f"got {[t.dtype for t in tensors]}")
    if src_b.dim() != 2 or any(t.shape != src_b.shape for t in ids + (vol,)):
        raise ValueError("delta_cost: the four id tables and vol must all be "
                         f"[R, K], got {[tuple(t.shape) for t in ids + (vol,)]}")
    C = hops.shape[0] if hops.dim() == 2 else -1
    if hops.shape != (C, C) or C < 1:
        raise ValueError(f"delta_cost: hops must be [C, C], got "
                         f"{tuple(hops.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("delta_cost: every input must be contiguous")
    return _launch(tensors)


delta_cost.launches = 0


def _delta_cost_unchecked(src_b: torch.Tensor, dst_b: torch.Tensor,
                          src_a: torch.Tensor, dst_a: torch.Tensor,
                          vol: torch.Tensor, hops: torch.Tensor) -> torch.Tensor:
    """:func:`delta_cost` without its argument checks, for a caller that
    builds every input to the contract itself (the device SA's
    ``_swap_delta``, once per step): CPU tensors take the plain version, CUDA
    tensors launch the kernel and count in ``delta_cost.launches``."""
    tensors = (src_b, dst_b, src_a, dst_a, vol, hops)
    if hops.device.type == "cpu":
        return delta_cost_plain(*tensors)
    return _launch(tensors)


def _launch(tensors) -> torch.Tensor:
    """Launch the kernel on the current stream, on inputs that meet the
    contract (checked by :func:`delta_cost` or built so by the caller)."""
    src_b, hops = tensors[0], tensors[5]
    dev = hops.device
    R, K = src_b.shape
    out = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(*(t.data_ptr() for t in tensors), out.data_ptr(), R, K,
                hops.shape[0], dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"delta_cost kernel launch failed: CUDA error {rc}")
    delta_cost.launches += 1
    return out
