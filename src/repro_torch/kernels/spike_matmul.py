"""Event-driven spike matmul: the CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by device.

``spikes [M, K]`` holds binary activations and ``w [K, N]`` weights; the
product is summed in float32 and returned in ``w.dtype``::

    out = spikes @ w

Spike activations are mostly zero, so whole spike tiles often are; the
kernel skips the multiply-adds of any all-zero tile. The kernel
(``csrc/spike_matmul.cu``) replaces the reference's Pallas kernel
``repro/kernels/spike_matmul.py::spike_matmul_pallas``; its source note
gives the design and the bound. The call contract is the reference's,
without its TPU padding of M, K and N. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes :func:`spike_matmul_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "spike_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_M, TILE_N, TILE_K = 64, 64, 16       # the kernel's block tile


def spike_matmul_plain(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: a float32 matmul cast to ``w.dtype``
    (``repro.kernels.ref.spike_matmul_ref``). On the card it is exact float32
    only with TF32 off (``torch.backends.cuda.matmul.allow_tf32``, off by
    default)."""
    return torch.matmul(spikes.float(), w.float()).to(w.dtype)


def zero_tiles(spikes: torch.Tensor, n: int) -> int:
    """How many (output tile, k-step) pairs the kernel skips for
    ``spikes [M, K]`` and ``n`` output columns: the all-zero
    ``TILE_M x TILE_K`` spike tiles (edges padded with zeros), once for each
    of the ``ceil(n / TILE_N)`` output-tile columns."""
    M, K = spikes.shape
    pm, pk = -M % TILE_M, -K % TILE_K
    tiles = torch.nn.functional.pad((spikes != 0).to(torch.uint8),
                                    (0, pk, 0, pm))
    tiles = tiles.reshape((M + pm) // TILE_M, TILE_M, (K + pk) // TILE_K,
                          TILE_K)
    empty = int((tiles.amax(dim=(1, 3)) == 0).sum().item())
    return empty * -(-n // TILE_N)


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_spike_matmul
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def spike_matmul_kernel(spikes: torch.Tensor, w: torch.Tensor, *,
                        skipped: torch.Tensor | None = None) -> torch.Tensor:
    """``spikes [M, K] @ w [K, N]`` in ``w.dtype``; both float32 or both
    bfloat16, contiguous. ``skipped``, a one-element int64 tensor on the
    same card, receives the number of (64 x 64 output tile, 16-deep k-step)
    pairs whose spike tile was all zero. CPU tensors take the plain version
    (and leave ``skipped`` alone)."""
    if spikes.device.type == "cpu" and w.device.type == "cpu":
        return spike_matmul_plain(spikes, w)
    dev = spikes.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"spikes on {spikes.device} and w on {w.device}: "
                         "both must be on one CUDA device (or both on the "
                         "CPU)")
    if spikes.dtype not in _DTYPES or w.dtype != spikes.dtype:
        raise TypeError("spike_matmul_kernel: spikes and w must both be "
                        f"float32 or both bfloat16, got {spikes.dtype} and "
                        f"{w.dtype}")
    if spikes.dim() != 2 or w.dim() != 2 or spikes.shape[1] != w.shape[0]:
        raise ValueError(f"spike_matmul_kernel: need spikes [M, K] and w "
                         f"[K, N], got {tuple(spikes.shape)} and "
                         f"{tuple(w.shape)}")
    if not (spikes.is_contiguous() and w.is_contiguous()):
        raise ValueError("spike_matmul_kernel: spikes and w must be "
                         "contiguous")
    if skipped is not None and (skipped.device != dev or
                                skipped.dtype != torch.int64 or
                                skipped.numel() != 1):
        raise ValueError("spike_matmul_kernel: skipped must be one int64 "
                         f"element on {dev}")
    (M, K), N = spikes.shape, w.shape[1]
    if max(M, K, N) >= 2 ** 31:
        raise ValueError(f"spike_matmul_kernel: dims {(M, K, N)} exceed int32")
    out = torch.empty(M, N, dtype=w.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(spikes.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
                _DTYPES[w.dtype],
                None if skipped is None else skipped.data_ptr(),
                dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"spike_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    spike_matmul_kernel.launches += 1
    return out


spike_matmul_kernel.launches = 0
