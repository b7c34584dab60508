"""The device SA's swap delta and its whole annealing loop: the CUDA kernels,
their plain PyTorch versions, and the wrappers that pick between them by
device.

A pairwise swap of two placement slots only perturbs the edges incident to
the (at most two) moved nodes, so the comm-cost change of a proposed swap is

    delta[r] = sum_k vol[r, k] * (hops[src_a[r, k], dst_a[r, k]]
                                  - hops[src_b[r, k], dst_b[r, k]])

over the K incident-edge entries that :func:`swap_tables` gathers for each
chain ``r`` from :class:`repro_torch.core.noc_batch.IncidentTables` (padding
entries carry ``vol == 0``).

* :func:`delta_cost` evaluates that sum for given tables: the reference's
  Pallas kernel ``repro/kernels/delta_cost.py::delta_cost_pallas``, without
  its TPU padding of C and K.
* :func:`sa_chains` runs R annealing chains of ``iters`` steps each, the
  delta of every step included, in one launch: the reference's jitted
  ``lax.scan`` around that kernel (``repro/core/placement/device_search.py::
  _sa_chains``). Its plain version :func:`sa_chains_plain` is the Python
  loop of tensor operations that calls a delta function once a step.

Both kernels live in ``csrc/delta_cost.cu``, whose note gives the designs
and the bounds. A CUDA tensor launches a kernel (or raises); a CPU tensor
takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "delta_cost"
SMEM_LIMIT = 232448         # dynamic shared memory a block may use (227 KB)
CHAINS_PER_BLOCK = 4        # sa_chains' warps (chains) a block, as in the .cu


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


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load(KERNEL), name)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _on_one_card(name: str, tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every input must be on one CUDA device (or "
                         f"all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


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
    dev = _on_one_card("delta_cost", tensors)
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
    R, K = src_b.shape
    out = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return out
    fn = _fn("repro_delta_cost",
             [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), R, K, C,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"delta_cost kernel launch failed: CUDA error {rc}")
    delta_cost.launches += 1
    return out


delta_cost.launches = 0


# ---------------------------------------------------------------------------
# The annealing loop
# ---------------------------------------------------------------------------

def full_cost(slots, hops, e_src, e_dst, e_vol, n: int):
    """Comm cost of each row's placement: float32 [R].

    Summed in float64 and rounded once, so a row's cost does not depend on
    how many rows the reduction sees (chain 0 is then the same whatever
    ``restarts`` is); on integer volumes with sums below 2^24 it equals the
    reference's float32 sum exactly."""
    p = slots[:, :n].long()
    h = hops[p[:, e_src], p[:, e_dst]].double()
    return (e_vol.double() * h).sum(dim=1).float()


def swap_tables(slots, i, j, inc_other, inc_vol, inc_src, n: int):
    """The endpoint tables of swapping ``slots[r, i[r]]``/``slots[r, j[r]]``:
    ``(src_b, dst_b, src_a, dst_a, vol)``, each ``[R, 2 D]`` (node a's D
    incident entries, then node b's), for :func:`delta_cost`.

    Device transcription of :func:`repro_torch.core.noc_batch.delta_comm_cost`,
    batched over the chain axis. Free-slot indices resolve to the all-padding
    sentinel row ``n`` of the incident tables, so no branching is needed.
    """
    R = slots.shape[0]
    rows = torch.arange(R, device=slots.device)
    ci, cj = slots[rows, i], slots[rows, j]
    a = torch.where(i < n, i, n)                    # node id or sentinel n
    b = torch.where(j < n, j, n)
    p_pad = torch.cat([slots[:, :n], slots.new_zeros(R, 1)], dim=1)
    nodes = torch.stack([a, b], dim=1)              # [R, 2]
    a3, b3 = a[:, None, None], b[:, None, None]
    ci3, cj3 = ci[:, None, None], cj[:, None, None]
    oth = inc_other[nodes]                          # [R, 2, D]
    # zero a–b edges in node b's half so they are not counted twice; in node
    # a's own half ``oth == a`` only hits padding (already volume 0)
    vol = torch.where(oth == a3, 0.0, inc_vol[nodes])
    is_s = inc_src[nodes]
    oc_b = p_pad.reshape(-1)[rows[:, None, None] * (n + 1) + oth]
    # the other endpoint moves too when it is the swap's partner node
    oc_a = torch.where(oth == a3, cj3, torch.where(oth == b3, ci3, oc_b))
    cu_before = torch.stack([ci, cj], dim=1)[..., None]   # [R, 2, 1]
    cu_after = torch.stack([cj, ci], dim=1)[..., None]
    D2 = 2 * oth.shape[2]
    return tuple(x.reshape(R, D2) for x in (
        torch.where(is_s, cu_before, oc_b), torch.where(is_s, oc_b, cu_before),
        torch.where(is_s, cu_after, oc_a), torch.where(is_s, oc_a, cu_after),
        vol))


def sa_chains_plain(slots0, t0_vec, cooling: float, inc_other, inc_vol,
                    inc_src, hops, e_src, e_dst, e_vol, *, draws, iters: int,
                    n: int, refresh_every: int, delta_fn=delta_cost_plain):
    """Plain version of :func:`sa_chains`: a Python loop of tensor
    operations, ``delta_fn`` (:func:`delta_cost_plain`, or :func:`delta_cost`
    to hold the kernel's loop against one launch a step) once a step."""
    i_all, j_all, u_all = draws
    R, S = slots0.shape
    cost0 = full_cost(slots0, hops, e_src, e_dst, e_vol, n)
    t = torch.clamp(t0_vec * torch.clamp(cost0, min=1.0), min=1e-9)
    rows = torch.arange(R, device=slots0.device)
    pos = torch.arange(S, device=slots0.device)[None, :]
    slots, cost, best_slots, best_cost = slots0, cost0, slots0, cost0
    traj = ([], [], [], [], [])
    for it in range(iters):
        i, j, u = i_all[it], j_all[it], u_all[it]
        proposed = ~((i == j) | ((i >= n) & (j >= n)))
        delta = delta_fn(*swap_tables(slots, i, j, inc_other, inc_vol,
                                      inc_src, n), hops)
        accept = proposed & (
            (delta <= 0)
            | (u < torch.exp(torch.clamp(-delta / torch.clamp(t, min=1e-9),
                                         max=0.0))))
        # arithmetic swap instead of a scatter: compares and selects over
        # [R, S], no per-row branching
        si, sj = slots[rows, i], slots[rows, j]
        swapped = torch.where(pos == i[:, None], sj[:, None],
                              torch.where(pos == j[:, None], si[:, None],
                                          slots))
        slots = torch.where(accept[:, None], swapped, slots)
        cost = cost + torch.where(accept, delta, 0.0)
        # bound float32 drift of the accumulated cost with a periodic exact
        # re-evaluation; the step counter lives on the host
        if (it + 1) % refresh_every == 0:
            cost = full_cost(slots, hops, e_src, e_dst, e_vol, n)
        improved = cost < best_cost
        best_cost = torch.where(improved, cost, best_cost)
        best_slots = torch.where(improved[:, None], slots, best_slots)
        t = t * cooling          # unconditional decay (fixed SA schedule)
        for acc, y in zip(traj, (cost, best_cost, t, accept, proposed)):
            acc.append(y)
    if iters:
        traj = tuple(torch.stack(y) for y in traj)
    else:
        traj = tuple(torch.empty(0, R, dtype=dtype, device=slots0.device)
                     for dtype in (torch.float32,) * 3 + (torch.bool,) * 2)
    return best_slots, best_cost, traj


def sa_layout(S: int, n: int, D: int, C: int) -> tuple[int, bool, bool]:
    """``(bytes, hops_shared, inc_shared)``: the dynamic shared memory of one
    :func:`sa_chains` block, and whether the hop table and then the incident
    tables fit in it beside the block's chains' slots."""
    used = CHAINS_PER_BLOCK * S * 4
    hops_shared = used + C * C * 4 <= SMEM_LIMIT
    used += C * C * 4 if hops_shared else 0
    inc_shared = used + (n + 1) * D * 9 <= SMEM_LIMIT
    used += (n + 1) * D * 9 if inc_shared else 0
    return used, hops_shared, inc_shared


_INT = (torch.int32, torch.int64)


def sa_chains(slots0, t0_vec, cooling: float, inc_other, inc_vol, inc_src,
              hops, e_src, e_dst, e_vol, *, draws, iters: int, n: int,
              refresh_every: int):
    """Advance R annealing chains ``iters`` steps in one launch.

    slots0 [R, S] int32 (row r: chain r's nodes in slots ``[0, n)``, free
    cores after), t0_vec [R] float32 (each chain's initial temperature as a
    fraction of its initial cost), ``cooling`` the per-step decay,
    inc_other [n+1, D] int32 / inc_vol float32 / inc_src bool (the incident
    tables with their sentinel row ``n``), hops [C, C] float32, e_src/e_dst
    [E] integer and e_vol [E] float32 (the graph's edges), ``draws = (i, j,
    u)``, each ``[iters, R]``: slot pairs in ``[0, S)`` (integer) and
    uniforms (float32). Returns ``(best_slots [R, S] int32, best_cost [R]
    float32, (cost, best_cost, t, accepted, proposed))``, the trajectory
    ``[iters, R]`` each (float32 x 3, bool x 2). CPU tensors take
    :func:`sa_chains_plain`."""
    i_all, j_all, u_all = draws
    tensors = (slots0, t0_vec, inc_other, inc_vol, inc_src, hops, e_src,
               e_dst, e_vol, i_all, j_all, u_all)
    kw = dict(draws=draws, iters=iters, n=n, refresh_every=refresh_every)
    if all(t.device.type == "cpu" for t in tensors):
        return sa_chains_plain(slots0, t0_vec, cooling, inc_other, inc_vol,
                               inc_src, hops, e_src, e_dst, e_vol, **kw)
    dev = _on_one_card("sa_chains", tensors)
    want = [(slots0, (torch.int32,)), (t0_vec, (torch.float32,)),
            (inc_other, (torch.int32,)), (inc_vol, (torch.float32,)),
            (inc_src, (torch.bool,)), (hops, (torch.float32,)),
            (e_src, _INT), (e_dst, _INT), (e_vol, (torch.float32,)),
            (i_all, _INT), (j_all, _INT), (u_all, (torch.float32,))]
    if any(t.dtype not in ok for t, ok in want):
        raise TypeError("sa_chains: need slots0/inc_other int32, inc_src "
                        "bool, t0_vec/inc_vol/hops/e_vol/u float32, e_src/"
                        f"e_dst/i/j int32 or int64; got "
                        f"{[t.dtype for t in tensors]}")
    R, S = slots0.shape if slots0.dim() == 2 else (-1, -1)
    C = hops.shape[0] if hops.dim() == 2 else -1
    D = inc_other.shape[1] if inc_other.dim() == 2 else -1
    E = e_src.shape[0] if e_src.dim() == 1 else -1
    shapes_ok = (
        R >= 1 and 1 <= n <= S <= C and hops.shape == (C, C)
        and t0_vec.shape == (R,) and D >= 1
        and all(t.shape == (n + 1, D) for t in (inc_other, inc_vol, inc_src))
        and all(t.shape == (E,) for t in (e_src, e_dst, e_vol))
        and all(t.shape == (iters, R) for t in draws))
    if not shapes_ok:
        raise ValueError(
            f"sa_chains: need slots0 [R, S], t0_vec [R], incident tables "
            f"[n+1, D], hops [C, C] with n <= S <= C, edges [E] and draws "
            f"[iters, R] (n={n}, iters={iters}); got "
            f"{[tuple(t.shape) for t in tensors]}")
    if refresh_every < 1:
        raise ValueError(f"sa_chains: refresh_every must be >= 1, got "
                         f"{refresh_every}")
    if not all(t.is_contiguous() for t in tensors[:9]):
        raise ValueError("sa_chains: slots0, t0_vec, the incident tables, "
                         "hops and the edges must be contiguous")
    smem, hops_shared, inc_shared = sa_layout(S, n, D, C)
    if CHAINS_PER_BLOCK * S * 4 > SMEM_LIMIT:
        raise ValueError(f"sa_chains: {CHAINS_PER_BLOCK} chains of {S} slots "
                         f"exceed {SMEM_LIMIT} bytes of shared memory")
    # the kernel indexes shared memory with these values: one check, one sync
    in_range = torch.stack([
        (inc_other.min() >= 0) & (inc_other.max() <= n),
        *(((t.min() >= 0) & (t.max() < n)) if E else
          torch.ones((), dtype=torch.bool, device=dev) for t in (e_src, e_dst)),
        *(((t.min() >= 0) & (t.max() < S)) if iters else
          torch.ones((), dtype=torch.bool, device=dev) for t in (i_all, j_all))])
    if not bool(in_range.all()):
        raise ValueError(f"sa_chains: need inc_other in [0, {n}], edge "
                         f"endpoints in [0, {n}) and draws i, j in [0, {S})")
    i_t, j_t = (t.t().to(torch.int32).contiguous() for t in (i_all, j_all))
    u_t = u_all.t().contiguous()
    best_slots = torch.empty_like(slots0)
    best_cost = torch.empty(R, dtype=torch.float32, device=dev)
    tr_f = torch.empty(3, R, iters, dtype=torch.float32, device=dev)
    tr_b = torch.empty(2, R, iters, dtype=torch.uint8, device=dev)
    ptrs = [slots0, t0_vec, inc_other, inc_vol, inc_src.view(torch.uint8),
            hops, e_src.to(torch.int32), e_dst.to(torch.int32), e_vol, i_t,
            j_t, u_t, best_slots, best_cost, tr_f[0], tr_f[1], tr_f[2],
            tr_b[0], tr_b[1]]
    fn = _fn("repro_sa_chains",
             [ctypes.c_void_p] * 19 + [ctypes.c_float] + [ctypes.c_int] * 10
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    rc = fn(*(t.data_ptr() for t in ptrs), float(cooling), R, S, n, D, C, E,
            iters, refresh_every, int(hops_shared), int(inc_shared), smem,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sa_chains kernel launch failed: CUDA error {rc}")
    sa_chains.launches += 1
    traj = (*tr_f.transpose(1, 2), *tr_b.view(torch.bool).transpose(1, 2))
    return best_slots, best_cost, traj


sa_chains.launches = 0
