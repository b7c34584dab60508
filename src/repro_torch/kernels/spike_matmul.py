"""Event-driven spike matmul: the CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by device.

``spikes [M, K]`` holds binary activations and ``w [K, N]`` weights; the
product is summed in float32 and returned in ``w.dtype``::

    out = spikes @ w

Spike activations are mostly zero, so whole spike tiles often are; the
kernel skips the products of any all-zero tile. The kernel
(``csrc/spike_matmul.cu``) replaces the reference's Pallas kernel
``repro/kernels/spike_matmul.py::spike_matmul_pallas``; its source note
gives the design and the bound. The call contract is the reference's
(``spikes`` in {0, 1}), without its TPU padding of M, K and N. A CUDA
tensor launches the kernel (or raises); a CPU tensor takes
:func:`spike_matmul_plain`.

The kernel runs on the tensor cores in bf16 with float32 sums. Spikes in
{0, 1} are exact in bf16, and so is any spike value that bf16 represents
exactly (0.5, 2, ...). A float32 weight goes in as the three bf16 terms of
:func:`split_bf16`, whose sum is the weight exactly, one product each,
summed in float32: each output is the float32 product up to the float32
summation order.
"""
from __future__ import annotations

import ctypes

import torch

from . import FLOATS, _build, working_dtype

KERNEL = "spike_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_M, TILE_N, TILE_K = 64, 64, 64       # the kernel's block tile
SPLIT_BELOW = 128     # output tiles under which K is split across blocks


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


def split_bf16(w: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The kernel's split of float32 weights into three bfloat16 terms, the
    8-bit slices of each significand: ``hi`` is ``w`` with its low 16 bits
    cleared, ``mid`` the same of ``w - hi``, ``lo`` what is left (at most 8
    significant bits). Each difference is exact in float32, so ``hi + mid +
    lo == w`` exactly while every remainder is a normal float32
    (``|w| >= 2**-110``)."""
    rest = w.float()
    terms = []
    for _ in range(3):
        top = (rest.view(torch.int32) & -65536).view(torch.float32)
        terms.append(top.to(torch.bfloat16))        # exact: low bits are 0
        rest = rest - top
    return tuple(terms)


def splits(m: int, k: int, n: int) -> tuple[int, int]:
    """``(splits, steps_per_split)``: how the kernel cuts K into ranges of
    ``TILE_K``-deep steps, one range a block, when ``spikes [m, k] @ w [k,
    n]`` has fewer than ``SPLIT_BELOW`` output tiles: enough ranges to give
    about ``SPLIT_BELOW`` blocks, none empty."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    steps = -(-k // TILE_K)
    if tiles >= SPLIT_BELOW or steps < 2:
        return 1, max(steps, 1)
    per = -(-steps // min(-(-SPLIT_BELOW // tiles), steps))
    return -(-steps // per), per


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_spike_matmul
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def spike_matmul_kernel(spikes: torch.Tensor, w: torch.Tensor, *,
                        skipped: torch.Tensor | None = None) -> torch.Tensor:
    """``spikes [M, K] @ w [K, N]`` in ``w.dtype``, as the reference
    returns it; each float32, bfloat16 or float16, contiguous. Both
    bfloat16 run the kernel in bfloat16; any other pair runs it on float32
    copies (exact) and rounds the float32 result once to ``w.dtype``.
    ``skipped``, a one-element int64 tensor on the same card, receives
    the number of (64 x 64 output tile, 64-deep k-step) pairs whose spike
    tile was all zero (:func:`zero_tiles`). When
    :func:`splits` cuts K, the float32 partial products go to a scratch
    tensor and a second kernel sums them in a fixed order, so repeated calls
    give identical results. CPU tensors take the plain version (and leave
    ``skipped`` alone)."""
    if spikes.device.type == "cpu" and w.device.type == "cpu":
        return spike_matmul_plain(spikes, w)
    dev = spikes.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"spikes on {spikes.device} and w on {w.device}: "
                         "both must be on one CUDA device (or both on the "
                         "CPU)")
    if spikes.dtype not in FLOATS or w.dtype not in FLOATS:
        raise TypeError("spike_matmul_kernel: spikes and w must be float32, "
                        f"bfloat16 or float16, got {spikes.dtype} and "
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
    out_dtype, work = w.dtype, working_dtype(spikes, w)
    spikes, w = spikes.to(work), w.to(work)
    out = torch.empty(M, N, dtype=work, device=dev)
    if M == 0 or N == 0:
        return out.to(out_dtype)
    n_split, per = splits(M, K, N)
    scratch = (torch.empty(n_split, M, N, dtype=torch.float32, device=dev)
               if n_split > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(spikes.data_ptr(), w.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), M, K, N,
                n_split, per, _DTYPES[w.dtype],
                None if skipped is None else skipped.data_ptr(),
                dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"spike_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    spike_matmul_kernel.launches += 1
    return out.to(out_dtype)


spike_matmul_kernel.launches = 0
