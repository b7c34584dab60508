"""Per-link NoC traffic as a per-row segment sum: the CUDA kernels, their
plain PyTorch versions, and the wrappers that pick between them by device.

``core.noc_batch`` reduces per-link traffic to a segment sum: every edge of
every placement adds its volume to each directed link on its route, with
routes stored as padded link-id tables (pad id == ``n_links``).
:func:`link_traffic` is the reference kernel's own contract, on ids and
weights already gathered per route hop::

    out[b, l] = sum_k w[b, k] * (ids[b, k] == l)

:func:`link_traffic_routes` is the same sum with the gather fused in, on
each edge's pair index into the route table, which is what the scorer
calls::

    out[b, l] = sum_{e, h} vol[e] * (routes[idx[b, e], h] == l)

The kernels (``csrc/noc_segsum.cu``) replace the reference's Pallas kernel
``repro/kernels/noc_segsum.py::link_traffic_pallas``; the source note gives
the design and the bounds. A CUDA tensor launches a kernel (or raises); a
CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "noc_segsum"
# the kernel holds a route-table row index in an int
_MAX_PAIRS = 2**31 - 1


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


def link_traffic_routes_plain(idx: torch.Tensor, routes: torch.Tensor,
                              vol: torch.Tensor, n_links: int) -> torch.Tensor:
    """Plain version: gather each edge's route, broadcast its volume over the
    route's hops and segment-sum with :func:`link_traffic_plain`. Float32
    ``[B, n_links]``."""
    ids = routes[idx]                                  # [B, E, H]
    B = ids.shape[0]
    w = vol[None, :, None].expand(ids.shape).reshape(B, -1)
    return link_traffic_plain(ids.reshape(B, -1), w, n_links)


def _routes_lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_link_traffic_routes
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def routes_occupancy(idx_dtype: torch.dtype, E: int, n_links: int) -> int:
    """Blocks of the fused kernel resident on one SM when it is launched for
    ``E`` edges and ``n_links`` links (CUDA's occupancy calculator)."""
    fn = _build.load(KERNEL).repro_link_traffic_routes_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(int(idx_dtype == torch.int64), E, n_links)


def link_traffic_routes(idx: torch.Tensor, routes: torch.Tensor,
                        vol: torch.Tensor, n_links: int) -> torch.Tensor:
    """Per-link traffic of every placement in one launch, the route gather
    fused into the segment sum: float32 ``[B, n_links]``, by definition
    ``link_traffic(routes[idx].reshape(B, -1), vol broadcast, n_links)``.

    idx [B, E] int32 or int64 pair indices into routes [P, H] int32 link ids
    in ``[0, n_links]`` (``n_links`` is padding and is dropped, as is any
    other id outside ``[0, n_links)``); vol [E] float32. On the card an idx
    outside ``[0, P)`` is a device-side error, as the plain gather's is. CPU
    tensors take the plain version.
    """
    tensors = (idx, routes, vol)
    if all(t.device.type == "cpu" for t in tensors):
        return link_traffic_routes_plain(idx, routes, vol, n_links)
    dev = idx.device
    if dev.type != "cuda" or routes.device != dev or vol.device != dev:
        raise ValueError("idx, routes and vol must be on one CUDA device (or "
                         "all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if (idx.dtype not in (torch.int32, torch.int64)
            or routes.dtype != torch.int32 or vol.dtype != torch.float32):
        raise TypeError("idx must be int32 or int64, routes int32 and vol "
                        f"float32, got {[t.dtype for t in tensors]}")
    if idx.dim() != 2 or routes.dim() != 2 or vol.shape != idx.shape[1:]:
        raise ValueError("idx must be [B, E], routes [P, H] and vol [E], got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("idx, routes and vol must be contiguous")
    (B, E), (P, H) = idx.shape, routes.shape
    if P > _MAX_PAIRS:
        raise ValueError(f"routes has {P} rows; the kernel takes at most "
                         f"{_MAX_PAIRS}")
    if B == 0 or E == 0 or H == 0 or n_links == 0:
        return torch.zeros(B, n_links, dtype=torch.float32, device=dev)
    out = torch.empty(B, n_links, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _routes_lib()(idx.data_ptr(), int(idx.dtype == torch.int64),
                       routes.data_ptr(), vol.data_ptr(), out.data_ptr(), B,
                       E, H, P, int(n_links), dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"link_traffic_routes kernel launch failed: CUDA "
                           f"error {rc}")
    link_traffic_routes.launches += 1
    return out


link_traffic_routes.launches = 0
