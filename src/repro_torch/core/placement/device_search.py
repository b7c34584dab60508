"""Device-resident placement search: SA and GA whose state never leaves the
device until the search ends.

The host searches (:mod:`.baselines`, :mod:`.population`) pay one Python
round-trip and one host scoring call per iteration. Here the whole search
stays on ``device`` (``None``: the card), with no host sync inside it:

* :func:`simulated_annealing_device` — pairwise-swap SA whose state is
  ``(slots, cost, best, temperature)``, advanced ``iters`` steps with
  **O(degree) incremental delta costs**: a swap of two slots only perturbs
  the edges incident to the (at most two) moved nodes, gathered from
  :class:`repro_torch.core.noc_batch.IncidentTables` (the numpy reference is
  :func:`repro_torch.core.noc_batch.delta_comm_cost`, bit-exact on
  integer-volume graphs). ``restarts=R`` runs R independent chains batched
  along the leading axis and returns the best chain. Chain ``c`` draws its
  proposals from its own ``torch.Generator`` seeded from ``(seed, c)``, so
  chain 0 is the same whatever ``restarts`` is (more restarts can only
  improve the returned best). On a CUDA device all chains run their whole
  search in one launch of the annealing kernel
  :func:`repro_torch.kernels.delta_cost.sa_chains`; elsewhere (and with
  ``use_pallas=False``) its plain version, a Python loop of tensor
  operations, runs instead. Float32 drift of the accumulated cost is bounded
  by an exact full re-evaluation every ``refresh_every`` steps.
* :func:`genetic_device` — the OX1-crossover evolutionary search as a loop
  of generations over a device-resident population: stable-argsort elitism,
  tournament selection, batched order crossover (membership scatter +
  cumsum-rank fill) and geometric pairwise-swap mutation, the whole
  population scored per generation on the device.

Both emit the same recorder trajectory semantics as their host counterparts
(``sa.iter`` / ``ga.gen``, one event per step/generation) by replaying the
search's per-step outputs host-side *after* the search — no per-step host
sync. The trajectory tensors are always kept; attaching a recorder only
fetches them, so results are identical with the recorder on or off.

The device path anneals in float32 and draws its own (torch) RNG streams, so
it is a distinct method variant — the host backends stay seed-for-seed
identical to the reference. Only ``objective="comm_cost"`` is supported: the
O(degree) delta decomposition is a property of the edge-separable comm cost
(use the host backends for ``max_link``/``energy``/composite objectives).
The operators take their random draws as arguments (``_sa_chains``'s
``draws``, ``_ox_device``'s ``ij``, ``_mutate_device``'s ``u``/``idx``), so
the tests can feed them the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ...deploy.objective import as_objective
from ...device import resolve_device
from ...kernels.delta_cost import full_cost, sa_chains, sa_chains_plain
from ..noc_batch import (batched_noc, build_incident_tables,
                         validate_placements)
from .baselines import core_pool, sigmate, zigzag


def _pool_array(noc) -> np.ndarray:
    pool = core_pool(noc)
    return np.arange(pool) if isinstance(pool, int) else np.asarray(pool)


def _check_objective(objective) -> None:
    if as_objective(objective if objective is not None
                    else "comm_cost").name != "comm_cost":
        raise ValueError(
            "backend='device' supports objective='comm_cost' only (the "
            "O(degree) delta decomposition needs an edge-separable cost); "
            "use the host backends for other objectives")


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` whose seed is a function of ``key`` only."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Simulated annealing: R restart chains on the device
# ---------------------------------------------------------------------------

def _sa_draws(seed: int, restarts: int, iters: int, S: int, device):
    """Every chain's proposal stream ``(i, j, u)``, each ``[iters, R]``,
    drawn up front; chain c's columns come from its own generator."""
    cols = []
    for c in range(restarts):
        g = _generator(device, seed, c)
        cols.append((
            torch.randint(0, S, (iters,), generator=g, device=device),
            torch.randint(0, S, (iters,), generator=g, device=device),
            torch.rand(iters, generator=g, device=device)))
    return tuple(torch.stack(x, dim=1) for x in zip(*cols))


def _sa_chains(slots0, t0_vec, cooling: float, inc_other, inc_vol, inc_src,
               hops_f, e_src, e_dst, e_vol, *, iters: int, n: int,
               refresh_every: int, use_pallas: bool, draws):
    """Advance R chains ``iters`` steps; ``draws = (i, j, u)``, each
    ``[iters, R]``. Returns ``(best_slots, best_cost, trajectory)`` with the
    trajectory ``(cost, best_cost, t, accepted, proposed)``, each
    ``[iters, R]``, still on the device.

    ``use_pallas`` (the reference's name) runs the chains through
    :func:`repro_torch.kernels.delta_cost.sa_chains`: on CUDA tensors one
    launch of the annealing kernel, whatever ``iters`` and R are; on CPU
    tensors its plain version. Otherwise the plain version runs on any
    device, with the plain delta."""
    kw = dict(draws=draws, iters=iters, n=n, refresh_every=refresh_every)
    args = (slots0, t0_vec, cooling, inc_other, inc_vol, inc_src, hops_f,
            e_src, e_dst, e_vol)
    if use_pallas:
        return sa_chains(*args, **kw)
    return sa_chains_plain(*args, **kw)


def _sa_setup(graph, noc, *, iters: int, t0: float, t_end_frac: float,
              seed: int, init, restarts: int, t0_spread: float,
              refresh_every: int, device):
    """The arguments of :func:`_sa_chains` for one search, on ``device``:
    ``(args, kw)``, with the chains' start placements, temperatures, tables
    and proposal draws."""
    rng = np.random.default_rng(seed)
    pool_arr = _pool_array(noc)
    n = graph.n
    base = np.asarray(init if init is not None else zigzag(n, noc), dtype=int)
    validate_placements(noc, base, n)
    free = np.setdiff1d(pool_arr, base)
    slots0 = np.empty((restarts, pool_arr.size), dtype=np.int32)
    slots0[0] = np.concatenate([base, free])
    pool = core_pool(noc)
    for r in range(1, restarts):
        slots0[r] = rng.permutation(pool)

    bn = batched_noc(noc)
    inc = build_incident_tables(graph)
    e_src, e_dst, e_vol, _ = bn.edge_arrays(graph)
    spread = (t0_spread ** (np.arange(restarts) / max(restarts - 1, 1))
              if restarts > 1 else np.ones(1))

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    args = (on_dev(slots0, torch.int32), on_dev(t0 * spread, torch.float32),
            float(np.float32(t_end_frac ** (1.0 / max(iters, 1)))),
            on_dev(inc.other, torch.int32), on_dev(inc.vol, torch.float32),
            on_dev(inc.is_src, torch.bool),
            on_dev(bn.tables.hops, torch.float32),
            on_dev(e_src, torch.int64), on_dev(e_dst, torch.int64),
            on_dev(e_vol, torch.float32))
    kw = dict(iters=iters, n=n, refresh_every=refresh_every,
              draws=_sa_draws(seed, restarts, iters, pool_arr.size, device))
    return args, kw


def simulated_annealing_device(graph, noc, iters: int = 5000,
                               t0: float = 0.05, t_end_frac: float = 1e-3,
                               seed: int = 0, init=None, restarts: int = 1,
                               t0_spread: float = 1.0,
                               objective="comm_cost", use_pallas=None,
                               refresh_every: int = 256,
                               recorder=None, device=None) -> np.ndarray:
    """Device-resident pairwise-swap SA, ``restarts`` parallel chains.

    All chains advance ``iters`` steps on ``device`` (``None``: the card)
    with O(degree) delta costs; the best placement across chains is
    returned. Chain 0 starts from ``init`` (zigzag by default), the others
    from random injective placements — the same multi-start convention as
    :func:`repro_torch.core.placement.population.simulated_annealing_population`.
    ``t0_spread`` stretches the chains' initial temperatures geometrically
    from ``t0`` to ``t0 * t0_spread`` (1.0 = all equal).
    ``use_pallas`` is kept for call compatibility with the reference's
    signature, not as a path to choose: ``None`` (and ``True``) runs the
    search as one launch of the ``sa_chains`` CUDA kernel on a CUDA device,
    ``False`` its plain version; on the CPU both run the plain version.
    ``recorder`` replays one ``sa.iter`` event per step of the winning
    chain after the search (identical schema to the host SA) plus one
    ``sa.device`` summary — results are identical with or without it.
    """
    if restarts < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    _check_objective(objective)
    dev = resolve_device(device)
    if use_pallas is None:
        use_pallas = dev.type == "cuda"
    args, kw = _sa_setup(graph, noc, iters=iters, t0=t0,
                         t_end_frac=t_end_frac, seed=seed, init=init,
                         restarts=restarts, t0_spread=t0_spread,
                         refresh_every=refresh_every, device=dev)
    best_slots, best_cost, traj = _sa_chains(
        *args, use_pallas=bool(use_pallas), **kw)
    best_cost = best_cost.cpu().numpy()
    win = int(np.argmin(best_cost))
    if recorder is not None:
        cost_tr, best_tr, t_tr, acc_tr, prop_tr = (
            y.cpu().numpy() for y in traj)
        for it in range(iters):
            recorder.event("sa.iter", iter=it, cost=float(cost_tr[it, win]),
                           best_cost=float(best_tr[it, win]),
                           temperature=float(t_tr[it, win]),
                           accepted=bool(acc_tr[it, win]),
                           proposed=bool(prop_tr[it, win]))
        n_acc = int(acc_tr[:, win].sum())
        if n_acc:
            recorder.count("sa.accepted", n_acc)
        recorder.event("sa.device", restarts=restarts, iters=iters,
                       best_chain=win, best_cost=float(best_cost[win]),
                       chain_best_mean=float(best_cost.mean()),
                       use_pallas=bool(use_pallas),
                       refresh_every=refresh_every)
    return best_slots[win, :graph.n].cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Genetic search: a loop of generations over a device-resident population
# ---------------------------------------------------------------------------

def _ox_device(ij, p1, p2, n_cores: int):
    """Batched OX1 crossover (device transcription of
    ``population._ox_crossover``): row b keeps ``p1[b, i:j)`` and fills the
    rest with ``p2[b]``'s cores in ``p2[b]``'s order starting after the
    segment, wrapping. ``ij`` [B, 2] holds the two cut draws in ``[0, S]``.
    """
    B, S = p1.shape
    i = torch.minimum(ij[:, 0], ij[:, 1])[:, None]
    j = torch.maximum(ij[:, 0], ij[:, 1])[:, None]
    pos = torch.arange(S, device=p1.device)[None, :]
    in_seg = (pos >= i) & (pos < j)
    member = torch.zeros(B, n_cores + 1, dtype=torch.bool, device=p1.device)
    member.scatter_(1, torch.where(in_seg, p1, n_cores).long(), True)
    take = ~member.gather(1, p2.long())      # p2 cores outside the segment
    dest = (j + torch.cumsum(take, dim=1) - 1) % S   # after segment, wrap
    # entries not taken all land in the dropped column S; which of those
    # duplicate writes wins is unspecified on CUDA, and none is kept
    child = torch.zeros(B, S + 1, dtype=p1.dtype, device=p1.device)
    child.scatter_(1, torch.where(take, dest, S), p2)
    child = torch.where(in_seg, p1, child[:, :S])
    return torch.where(i == j, p1, child)


def _mutate_device(u, idx, child, rate: float):
    """Geometric pairwise-swap mutation, truncated at ``kmax`` swaps (the
    host draws a geometric number of swaps, ~1.5 expected at rate 0.6;
    P(>8) < 2%). ``u`` [B, kmax] uniforms gate the swaps (a row keeps
    swapping while its coins say so), ``idx`` [B, kmax, 2] are the slots."""
    gate = (u < rate).to(torch.int32).cumprod(dim=1) > 0
    rows = torch.arange(child.shape[0], device=child.device)
    child = child.clone()
    for k in range(u.shape[1]):
        a, b = idx[:, k, 0], idx[:, k, 1]
        va, vb = child[rows, a], child[rows, b]
        g = gate[:, k]
        child[rows, a] = torch.where(g, vb, va)
        child[rows, b] = torch.where(g, va, vb)
    return child


def _ga_draws(seed: int, generations: int, n_child: int, P: int, S: int,
              tournament: int, kmax: int, device):
    """Every generation's draws up front, from one generator: tournament
    candidates, crossover coins, crossover cuts, mutation coins and slots."""
    g = _generator(device, seed)
    G = generations
    return (torch.randint(0, P, (G, n_child, 2, tournament), generator=g,
                          device=device),
            torch.rand(G, n_child, generator=g, device=device),
            torch.randint(0, S + 1, (G, n_child, 2), generator=g,
                          device=device),
            torch.rand(G, n_child, kmax, generator=g, device=device),
            torch.randint(0, S, (G, n_child, kmax, 2), generator=g,
                          device=device))


def _ga_generations(slots0, hops_f, e_src, e_dst, e_vol,
                    crossover_rate: float, mutation_rate: float, draws, *,
                    generations: int, n: int, n_elite: int):
    P, S = slots0.shape
    C = hops_f.shape[0]
    cand_all, cx_all, ij_all, mu_all, mi_all = draws

    def stats(slots, cost, i1):
        return (cost[i1], cost.mean(),
                (slots[:, :n] != slots[i1, :n]).float().mean())

    slots = slots0
    cost = full_cost(slots, hops_f, e_src, e_dst, e_vol, n)
    i0 = torch.argmin(cost)
    best_slots, best_cost = slots[i0], cost[i0]
    init_stats = stats(slots, cost, i0)
    traj = []
    for gen in range(generations):
        order = torch.argsort(cost, stable=True)
        elite = slots[order[:n_elite]]
        cand = cand_all[gen]                           # [n_child, 2, T]
        win = torch.gather(cand, 2, torch.argmin(cost[cand], dim=2,
                                                 keepdim=True))[..., 0]
        p1, p2 = slots[win[:, 0]], slots[win[:, 1]]
        children = _ox_device(ij_all[gen], p1, p2, C)
        children = torch.where((cx_all[gen] < crossover_rate)[:, None],
                               children, p1)
        children = _mutate_device(mu_all[gen], mi_all[gen], children,
                                  mutation_rate)
        slots = torch.cat([elite, children])
        cost = full_cost(slots, hops_f, e_src, e_dst, e_vol, n)
        i1 = torch.argmin(cost)
        improved = cost[i1] < best_cost
        best_cost = torch.where(improved, cost[i1], best_cost)
        best_slots = torch.where(improved, slots[i1], best_slots)
        cur_min, cur_mean, div = stats(slots, cost, i1)
        traj.append(torch.stack([best_cost, cur_min, cur_mean, div]))
    traj = (torch.stack(traj) if traj
            else torch.empty(0, 4, device=slots0.device))
    return best_slots, best_cost, torch.stack(init_stats), traj


def genetic_device(graph, noc, generations: int = 80, pop_size: int = 64,
                   elite_frac: float = 0.125, tournament: int = 3,
                   crossover_rate: float = 0.9, mutation_rate: float = 0.6,
                   seed: int = 0, init=None, objective="comm_cost",
                   recorder=None, device=None) -> np.ndarray:
    """Device-resident evolutionary search on ``device`` (``None``: the
    card).

    Same operators and hyper-parameters as
    :func:`repro_torch.core.placement.population.genetic_population`
    (stable-sort elitism, tournament selection, OX1 crossover, geometric
    pairwise-swap mutation — truncated at 8 swaps on device), with the whole
    population evolved and scored on the device. RNG streams are torch's, so
    it is a method variant, not a replay of the host GA. ``recorder`` replays
    one ``ga.gen`` event per generation (host schema, including the initial
    ``gen=-1``) after the search.
    """
    if pop_size < 2:
        raise ValueError(f"pop_size must be >= 2, got {pop_size}")
    if tournament < 1:
        raise ValueError(f"tournament must be >= 1, got {tournament}")
    _check_objective(objective)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pool_arr = _pool_array(noc)
    n = graph.n

    def full_perm(placement):
        placement = np.asarray(placement, dtype=int)
        free = np.setdiff1d(pool_arr, placement)
        return np.concatenate([placement, free])

    slots0 = np.empty((pop_size, pool_arr.size), dtype=np.int32)
    if init is not None:
        validate_placements(noc, np.asarray(init, dtype=int), n)
        slots0[0] = full_perm(init)
    else:
        slots0[0] = full_perm(zigzag(n, noc))
    slots0[1] = full_perm(sigmate(n, noc))
    pool = core_pool(noc)
    for p in range(2, pop_size):
        slots0[p] = rng.permutation(pool)

    bn = batched_noc(noc)
    e_src, e_dst, e_vol, _ = bn.edge_arrays(graph)
    n_elite = max(1, int(round(elite_frac * pop_size)))
    kmax = 8
    best_slots, best_cost, init_stats, traj = _ga_generations(
        torch.as_tensor(slots0, device=dev),
        torch.as_tensor(bn.tables.hops, dtype=torch.float32, device=dev),
        torch.as_tensor(e_src, device=dev), torch.as_tensor(e_dst, device=dev),
        torch.as_tensor(e_vol, dtype=torch.float32, device=dev),
        float(np.float32(crossover_rate)), float(np.float32(mutation_rate)),
        _ga_draws(seed, generations, pop_size - n_elite, pop_size,
                  pool_arr.size, tournament, kmax, dev),
        generations=generations, n=n, n_elite=n_elite)
    if recorder is not None:
        c0, mean0, div0 = (float(x) for x in init_stats.cpu().numpy())
        recorder.event("ga.gen", gen=-1, best_cost=c0, cur_min=c0,
                       cur_mean=mean0, diversity=div0)
        for gen, (best, cur_min, cur_mean, div) in enumerate(
                traj.cpu().numpy()):
            recorder.event("ga.gen", gen=gen, best_cost=float(best),
                           cur_min=float(cur_min), cur_mean=float(cur_mean),
                           diversity=float(div))
    return best_slots[:n].cpu().numpy().astype(np.int64)
