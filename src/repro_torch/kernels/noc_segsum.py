"""Per-link NoC traffic as a per-row segment sum: the CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

``core.noc_batch`` reduces per-link traffic to a segment sum: every edge of
every placement adds its volume to each directed link on its route, with
routes stored as padded link-id tables (pad id == ``n_links``)::

    out[b, l] = sum_k w[b, k] * (ids[b, k] == l)

The kernel (``csrc/noc_segsum.cu``) replaces the reference's Pallas kernel
``repro/kernels/noc_segsum.py::link_traffic_pallas``; its source note gives
the design and the bound. A CUDA tensor launches the kernel (or raises); a
CPU tensor takes :func:`link_traffic_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "noc_segsum"


def link_traffic_plain(ids: torch.Tensor, w: torch.Tensor,
                       n_links: int) -> torch.Tensor:
    """Plain version: scatter into ``n_links + 1`` bins (the last one takes
    the pad id) and drop the pad bin. Float32 ``[B, n_links]``."""
    B = ids.shape[0]
    out = torch.zeros(B, n_links + 1, dtype=torch.float32, device=ids.device)
    return out.scatter_add_(1, ids.long(), w.float())[:, :n_links]


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_link_traffic
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    return fn


def link_traffic(ids: torch.Tensor, w: torch.Tensor,
                 n_links: int) -> torch.Tensor:
    """Segment-sum ``w`` over ``ids`` into float32 ``[B, n_links]``.

    ids [B, K] int32 link ids in ``[0, n_links]`` (``n_links`` is padding and
    is dropped); w [B, K] float32. CPU tensors take the plain version.
    """
    if ids.device.type == "cpu" and w.device.type == "cpu":
        return link_traffic_plain(ids, w, n_links)
    if ids.device.type != "cuda" or w.device != ids.device:
        raise ValueError(f"ids on {ids.device} and w on {w.device}: both must "
                         "be on one CUDA device (or both on the CPU)")
    if ids.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"ids must be int32 and w float32, got {ids.dtype} "
                        f"and {w.dtype}")
    if ids.dim() != 2 or w.shape != ids.shape:
        raise ValueError(f"ids and w must both be [B, K], got "
                         f"{tuple(ids.shape)} and {tuple(w.shape)}")
    if not (ids.is_contiguous() and w.is_contiguous()):
        raise ValueError("ids and w must be contiguous")
    B, K = ids.shape
    if B == 0 or n_links == 0:
        return torch.zeros(B, n_links, dtype=torch.float32, device=ids.device)
    out = torch.empty(B, n_links, dtype=torch.float32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    rc = _lib()(ids.data_ptr(), w.data_ptr(), out.data_ptr(), B, K,
                int(n_links), ids.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"link_traffic kernel launch failed: CUDA error {rc}")
    link_traffic.launches += 1
    return out


link_traffic.launches = 0
