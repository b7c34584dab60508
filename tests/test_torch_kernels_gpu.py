"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips, with a reason, on a host without
CUDA; the ``cuda`` fixture decides at run time, never at import. On the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Integer weights whose partial sums stay below 2^24 must match exactly.
``link_traffic``'s float weights agree within rtol=1e-5, atol=1e-3
(shared-memory atomics add in a run-dependent order); ``delta_cost``'s float
volumes within 1e-5 of each chain's sum of absolute terms (its warp
reduction adds in another order than the plain row sum). The LIF kernel is
bit-identical to its plain version in float32 and bfloat16 (both compute in
float32 in the same order and round once). The fused LIF backward is bit
for bit its plain version in float32 with the rect surrogate (any alpha,
any cotangent absent, any of d_u / d_s skipped); sigmoid and atan agree
within rtol=1e-5, atol=1e-6, and bfloat16 within 2^-5 of each result's
largest magnitude. ``link_traffic_routes`` (the route gather fused into the
segment sum) is exact on integer volumes and within rtol=1e-5, atol=1e-3 on
float volumes, for int32 and int64 pair indices, and an out-of-range pair
index is a device-side error. ``spike_matmul`` agrees within
rtol=atol=1e-4 and within 1e-4 + 1e-4 x (|spikes| @ |w|) in float32
(bf16 tensor cores on three bf16 slices that sum to each weight, in
another summation order than cuBLAS) and rtol=atol=1e-2 in bfloat16 (one
rounding of the output), its count of skipped tiles is exact, and split-K
results repeat bit for bit. A full-width Spike-VGG16 training step
through the LIF kernel is bit-identical to the same step through the plain
version, with deterministic cuDNN. The flash-attention kernel agrees with
its plain version within rtol=atol=1e-5 in float32 and 1e-2 in bfloat16, and
a smoke-size model served on the card goes through it; its lse matches the
plain version's within 1e-5 (float32). The flash backward kernel agrees with
its plain version within 1e-4 of each gradient's largest magnitude in
float32 and relative L2 2e-2 in bfloat16 (the tensor cores at every head
dim up to 256, each bf16 call counted as a tensor-core launch), and repeats
bit for bit; attention gradients on the card (through both
kernels) match the CPU's within 1e-4, as do a smoke-size model's loss and
gradients under remat. The annealing
kernel ``sa_chains`` is bit-identical to the plain loop that launches
``delta_cost`` once a step: best slots, best costs and the whole
trajectory. float16 and mixed inputs of the compute kernels run in float32
and return the reference's dtype, against their plain versions at the
tolerances above. The placement front end on the card: the policy baseline
scores through the fused link-traffic kernel, the collision resolver is
exact against numpy, and fused service searches equal serial ones bit for
bit. The RoPE kernel is bit for bit the torch ops it replaced, forward and
autograd's gradient, at every model's shape and internlm2's full one, and a
smoke training step under remat launches it 4 x L times forward and 2 x L
inverse, each launch in the ``model.rope`` span of its pass.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import NoC  # noqa: E402
from repro_torch.kernels.delta_cost import (delta_cost,  # noqa: E402
                                            delta_cost_plain, sa_chains,
                                            sa_chains_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_kernel, flash_attention_backward_plain,
    flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.lif import (  # noqa: E402
    lif_backward_kernel, lif_backward_plain, lif_step_kernel, lif_step_plain)
from repro_torch.kernels.rope import rope_kernel, rope_plain  # noqa: E402
from repro_torch.kernels.noc_segsum import (  # noqa: E402
    link_traffic, link_traffic_plain, link_traffic_routes,
    link_traffic_routes_plain)
from repro_torch.kernels.spike_matmul import (  # noqa: E402
    spike_matmul_kernel, spike_matmul_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


SHAPES = [(3, 500, 256), (1, 7, 16), (2, 130, 20), (4, 1024, 100),
          (256, 4340, 256), (16, 19888, 1024), (2, 4096, 20000)]


@pytest.mark.parametrize("B,K,n_links", SHAPES)
@pytest.mark.parametrize("kind", ["int", "float"])
def test_link_traffic_kernel_matches_plain(cuda, B, K, n_links, kind):
    rng = np.random.default_rng(B * 7 + K)
    ids = torch.as_tensor(rng.integers(0, n_links + 1, (B, K)),
                          dtype=torch.int32, device=cuda)
    w = (rng.integers(0, 16, (B, K)) if kind == "int" else rng.random((B, K)))
    w = torch.as_tensor(w, dtype=torch.float32, device=cuda)
    before = link_traffic.launches
    got = link_traffic(ids, w, n_links)
    torch.cuda.synchronize()
    assert link_traffic.launches == before + 1
    want = link_traffic_plain(ids, w, n_links)
    assert got.shape == (B, n_links) and got.dtype == torch.float32
    if kind == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_link_traffic_kernel_drops_padding_and_out_of_range(cuda):
    ids = torch.tensor([[16, 16, -1, 99, 3, 3]], dtype=torch.int32,
                       device=cuda)
    w = torch.ones(1, 6, device=cuda)
    out = link_traffic(ids, w, 16)
    torch.cuda.synchronize()
    expect = torch.zeros(1, 16, device=cuda)
    expect[0, 3] = 2.0
    assert torch.equal(out, expect)


def test_link_traffic_kernel_rejects_bad_inputs(cuda):
    ids = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    w = torch.ones(2, 8, device=cuda)
    with pytest.raises(TypeError):
        link_traffic(ids.long(), w, 4)
    with pytest.raises(TypeError):
        link_traffic(ids, w.double(), 4)
    with pytest.raises(ValueError):
        link_traffic(ids, w[:, :4], 4)
    with pytest.raises(ValueError):
        link_traffic(ids.t(), w.t(), 4)
    with pytest.raises(ValueError):
        link_traffic(ids, w.cpu(), 4)


# (B, E, P, H, n_links): the PPO rollout shape on the 8x8 mesh (E = 310
# edges of the 64-slice Spike-VGG16 graph, H = 14 hops, P = 64 x 64 pairs),
# E off the 32-edge chunk, one hop, routes longer than a warp, one edge, and
# a link axis of three tiles (n_links > 8192)
ROUTE_SHAPES = [(256, 310, 4096, 14, 256), (3, 45, 100, 5, 20),
                (4, 70, 64, 1, 16), (2, 40, 50, 40, 300), (5, 1, 9, 3, 7),
                (4, 200, 4096, 14, 20000)]


def _route_inputs(B, E, P, H, n_links, kind, idx_dtype, seed, device):
    """Random route table (link ids in [0, n_links], the back half of each
    row padded with n_links at random), pair indices and volumes."""
    rng = np.random.default_rng(seed)
    routes = rng.integers(0, n_links + 1, (P, H))
    routes[:, H // 2:][rng.random((P, H - H // 2)) < 0.5] = n_links
    idx = rng.integers(0, P, (B, E))
    vol = (rng.integers(0, 16, E) if kind == "int" else rng.random(E))
    return (torch.as_tensor(idx, dtype=idx_dtype, device=device),
            torch.as_tensor(routes, dtype=torch.int32, device=device),
            torch.as_tensor(vol, dtype=torch.float32, device=device))


@pytest.mark.parametrize("B,E,P,H,n_links", ROUTE_SHAPES)
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_link_traffic_routes_kernel_matches_plain(cuda, B, E, P, H, n_links,
                                                  kind, idx_dtype):
    idx, routes, vol = _route_inputs(B, E, P, H, n_links, kind, idx_dtype,
                                     B * 31 + E, cuda)
    before = link_traffic_routes.launches
    got = link_traffic_routes(idx, routes, vol, n_links)
    torch.cuda.synchronize()
    assert link_traffic_routes.launches == before + 1
    want = link_traffic_routes_plain(idx, routes, vol, n_links)
    assert got.shape == (B, n_links) and got.dtype == torch.float32
    if kind == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_link_traffic_routes_kernel_drops_padding_and_out_of_range(cuda):
    """Route ids equal to n_links (padding), negative or past n_links add
    nothing, by hand; every pair of both rows is walked."""
    routes = torch.tensor([[16, 16, -1], [99, 3, 3], [0, 15, 16]],
                          dtype=torch.int32, device=cuda)
    idx = torch.tensor([[1, 2, 0], [2, 2, 1]], device=cuda)
    vol = torch.tensor([1.0, 2.0, 4.0], device=cuda)
    out = link_traffic_routes(idx, routes, vol, 16)
    torch.cuda.synchronize()
    expect = torch.zeros(2, 16, device=cuda)
    expect[0, 3], expect[0, 0], expect[0, 15] = 2.0, 2.0, 2.0
    expect[1, 0], expect[1, 15], expect[1, 3] = 3.0, 3.0, 8.0
    assert torch.equal(out, expect)


def test_link_traffic_routes_kernel_on_a_degraded_mesh(cuda):
    """The scorer's own tables of an 8x8 mesh with dropped links and a
    dropped core (detour routes), live placements, integer volumes."""
    from repro_torch.core.noc_batch import batched_noc
    from repro_torch.core.topology import degrade
    noc = degrade(NoC(8, 8), links=(5, 40), nodes=(27,))
    b = batched_noc(noc)
    dt = b.device_tables(cuda)
    rng = np.random.default_rng(4)
    alive = noc.alive_cores()
    P = np.stack([rng.permutation(alive)[:40] for _ in range(64)])
    src, dst = rng.integers(0, 40, (2, 300))
    idx = torch.as_tensor(np.ascontiguousarray(P[:, src] * noc.n_cores
                                               + P[:, dst]), device=cuda)
    vol = torch.as_tensor(rng.integers(1, 100, 300), dtype=torch.float32,
                          device=cuda)
    got = link_traffic_routes(idx, dt.routes, vol, b.tables.n_links)
    torch.cuda.synchronize()
    want = link_traffic_routes_plain(idx, dt.routes, vol, b.tables.n_links)
    assert torch.equal(got, want)


def test_link_traffic_routes_kernel_rejects_bad_inputs(cuda):
    idx, routes, vol = _route_inputs(2, 8, 10, 3, 4, "int", torch.int64, 0,
                                     cuda)
    before = link_traffic_routes.launches
    with pytest.raises(TypeError):
        link_traffic_routes(idx.short(), routes, vol, 4)
    with pytest.raises(TypeError):
        link_traffic_routes(idx, routes.long(), vol, 4)
    with pytest.raises(TypeError):
        link_traffic_routes(idx, routes, vol.double(), 4)
    with pytest.raises(ValueError):
        link_traffic_routes(idx, routes, vol[:4], 4)
    with pytest.raises(ValueError):
        link_traffic_routes(idx[0], routes, vol, 4)
    with pytest.raises(ValueError):
        link_traffic_routes(idx, routes.t(), vol, 4)
    with pytest.raises(ValueError):
        link_traffic_routes(idx.t().contiguous().t(), routes, vol, 4)
    with pytest.raises(ValueError):
        link_traffic_routes(idx, routes.cpu(), vol, 4)
    assert link_traffic_routes.launches == before


@pytest.mark.parametrize("bad", ["P", "-1"])
def test_link_traffic_routes_kernel_faults_on_an_out_of_range_idx(cuda, bad):
    """An idx outside [0, P) is a device-side error (the plain gather's is
    a device-side assert), not a silently dropped edge. The fault poisons
    the process's CUDA context, so it runs in a process of its own."""
    code = textwrap.dedent(f"""
        import torch
        from repro_torch.kernels.noc_segsum import link_traffic_routes
        routes = torch.zeros(16, 3, dtype=torch.int32, device="cuda")
        idx = torch.zeros(2, 5, dtype=torch.int64, device="cuda")
        idx[1, 3] = 16 if {bad!r} == "P" else -1
        out = link_traffic_routes(idx, routes, torch.ones(5, device="cuda"), 4)
        torch.cuda.synchronize()
        print("no error", out.sum().item())
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0, proc.stdout
    assert "no error" not in proc.stdout
    assert any(m in proc.stderr for m in ("CUDA error", "AcceleratorError",
                                          "illegal instruction")), \
        proc.stderr[-2000:]


# (R, K, hop table): the reference kernel test's shape, the SA path's shape
# (64 chains, K = 2 * max degree 16 of the 64-slice Spike-VGG16 graph, 8x8
# mesh), R=1/K=1, the reference's K tiling crossed, a 16x16 torus and a
# 32x32 mesh
DELTA_SHAPES = [(4, 23, "rand32"), (64, 32, "mesh:8x8"), (1, 1, "mesh:8x8"),
                (3, 300, "rand40"), (64, 32, "torus:16x16"),
                (1024, 1024, "mesh:32x32")]


def _hops(spec, rng):
    if spec.startswith("rand"):
        C = int(spec[4:])
        return rng.integers(0, 9, (C, C)).astype(np.float32)
    kind, shape = spec.split(":")
    rows, cols = (int(x) for x in shape.split("x"))
    return NoC(rows, cols, torus=kind == "torus").hops_matrix().astype(
        np.float32)


def _delta_inputs(R, K, spec, kind, seed, device):
    rng = np.random.default_rng(seed)
    hops = _hops(spec, rng)
    C = hops.shape[0]
    ids = [torch.as_tensor(rng.integers(0, C, (R, K)), dtype=torch.int32,
                           device=device) for _ in range(4)]
    vol = (rng.integers(0, 40, (R, K)) if kind == "int"
           else rng.random((R, K)) * 1e3)
    vol[:, K // 2:] *= (rng.random((R, 1)) < 0.25)   # some all-padding tails
    vol = torch.as_tensor(vol, dtype=torch.float32, device=device)
    return ids + [vol, torch.as_tensor(hops, device=device)]


@pytest.mark.parametrize("R,K,spec", DELTA_SHAPES)
@pytest.mark.parametrize("kind", ["int", "float"])
def test_delta_cost_kernel_matches_plain(cuda, R, K, spec, kind):
    args = _delta_inputs(R, K, spec, kind, R * 31 + K, cuda)
    before = delta_cost.launches
    got = delta_cost(*args)
    torch.cuda.synchronize()
    assert delta_cost.launches == before + 1
    want = delta_cost_plain(*args)
    assert got.shape == (R,) and got.dtype == torch.float32
    if kind == "int":
        assert torch.equal(got, want)
    else:
        sb, db, sa, da, vol, hops = args
        C = hops.shape[0]
        flat = hops.reshape(-1)
        scale = (vol * (flat[sa.long() * C + da.long()]
                        - flat[sb.long() * C + db.long()]).abs()).sum(1)
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def test_delta_cost_kernel_all_padding_rows(cuda):
    args = _delta_inputs(8, 40, "mesh:8x8", "int", 3, cuda)
    args[4] = torch.zeros_like(args[4])
    out = delta_cost(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros(8, device=cuda))


def test_delta_cost_kernel_rejects_bad_inputs(cuda):
    sb, db, sa, da, vol, hops = _delta_inputs(4, 16, "mesh:4x4", "int", 0,
                                              cuda)
    before = delta_cost.launches
    with pytest.raises(TypeError):
        delta_cost(sb.long(), db, sa, da, vol, hops)
    with pytest.raises(TypeError):
        delta_cost(sb, db, sa, da, vol.double(), hops)
    with pytest.raises(TypeError):
        delta_cost(sb, db, sa, da, vol, hops.double())
    with pytest.raises(ValueError):
        delta_cost(sb, db, sa, da[:, :8], vol, hops)
    with pytest.raises(ValueError):
        delta_cost(sb, db, sa, da, vol, hops[:, :8])
    with pytest.raises(ValueError):
        delta_cost(sb.t(), db.t(), sa.t(), da.t(), vol.t(), hops)
    with pytest.raises(ValueError):
        delta_cost(sb, db, sa, da, vol.cpu(), hops)
    assert delta_cost.launches == before


def test_device_sa_kernel_path_matches_plain_path(cuda):
    """The device SA through the annealing kernel (one launch a search, no
    ``delta_cost`` launch) and through its plain version: the same
    placement on an integer-volume graph, whose partial sums stay below
    2^24 so both add exactly."""
    from repro_torch.core import graph, topology
    from repro_torch.core.placement import device_search
    g = graph.random_dag(24, p=0.3, seed=2)
    g = graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    noc = topology.parse_topology("mesh:4x8")
    kw = dict(iters=150, seed=3, restarts=3, device=cuda)
    before = (delta_cost.launches, sa_chains.launches)
    plain = device_search.simulated_annealing_device(g, noc, use_pallas=False,
                                                     **kw)
    assert (delta_cost.launches, sa_chains.launches) == before
    kernel = device_search.simulated_annealing_device(g, noc, **kw)
    assert (delta_cost.launches, sa_chains.launches) == (before[0],
                                                         before[1] + 1)
    assert np.array_equal(kernel, plain)


# (id, topology, faults, graph nodes, edge probability, chains R, steps,
# refresh_every): meshes 4x8 and 8x8, a torus, a degraded mesh (a dropped
# core and link), C=256 past the hop table's room in shared memory, incident
# tables past theirs (a dense 120-node graph beside a 200-core hop table; and
# on 32x32 both), and the edges: no steps, one chain (a partial block, as are
# R=5, 7, 12 and 24), refresh past the steps, a small graph on many free slots
SA_CASES = [
    ("mesh4x8", "mesh:4x8", (), 24, 0.3, 16, 400, 64),
    ("mesh8x8", "mesh:8x8", (), 64, 0.1, 64, 600, 256),
    ("torus8x8", "torus:8x8", (), 48, 0.15, 32, 500, 100),
    ("degraded", "mesh:8x8", ((3, 40), (9,)), 40, 0.2, 24, 500, 128),
    ("mesh16x16-C256", "mesh:16x16", (), 120, 0.05, 16, 400, 256),
    ("inc-global", "mesh:10x20", (), 120, 0.6, 8, 200, 64),
    ("mesh32x32", "mesh:32x32", (), 600, 0.05, 4, 150, 50),
    ("iters0", "mesh:4x8", (), 24, 0.3, 5, 0, 64),
    ("R1", "mesh:8x8", (), 64, 0.1, 1, 300, 256),
    ("refresh-past-iters", "mesh:4x8", (), 24, 0.3, 7, 90, 1000),
    ("free-slots", "mesh:8x8", (), 10, 0.5, 12, 300, 32),
]


def _sa_case(dev, spec, faults, n, p, R, iters, refresh, seed=0):
    from repro_torch.core import graph, topology
    from repro_torch.core.placement import device_search
    g = graph.random_dag(n, p=p, seed=seed + n)
    g = graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    noc = topology.parse_topology(spec)
    if faults:
        noc = topology.degrade(noc, links=faults[0], nodes=faults[1])
    args, kw = device_search._sa_setup(
        g, noc, iters=iters, t0=0.05, t_end_frac=1e-3, seed=seed, init=None,
        restarts=R, t0_spread=4.0, refresh_every=refresh, device=dev)
    i_all, j_all, _ = kw["draws"]
    j_all[::7] = i_all[::7]                  # i == j: never proposed
    return args, kw


@pytest.mark.parametrize("name,spec,faults,n,p,R,iters,refresh", SA_CASES,
                         ids=[c[0] for c in SA_CASES])
def test_sa_chains_kernel_is_bit_identical_to_the_delta_cost_loop(
        cuda, name, spec, faults, n, p, R, iters, refresh):
    """One launch of the annealing kernel against the plain loop launching
    ``delta_cost`` once a step, on the same draws: best slots, best costs
    and all five trajectories bit for bit (integer volumes, so the float64
    refreshes are exact in any order)."""
    from repro_torch.kernels.delta_cost import sa_layout
    args, kw = _sa_case(cuda, spec, faults, n, p, R, iters, refresh)
    before = (sa_chains.launches, delta_cost.launches)
    got = sa_chains(*args, **kw)
    torch.cuda.synchronize()
    assert (sa_chains.launches, delta_cost.launches) == (before[0] + 1,
                                                         before[1])
    want = sa_chains_plain(*args, delta_fn=delta_cost, **kw)
    assert delta_cost.launches == before[1] + iters
    S, C = args[0].shape[1], args[6].shape[0]
    _, hops_shared, inc_shared = sa_layout(S, n, args[3].shape[1], C)
    if name == "mesh16x16-C256":
        assert not hops_shared
    if name == "inc-global":
        assert hops_shared and not inc_shared
    if name == "mesh32x32":
        assert not hops_shared and not inc_shared
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert a.shape == b.shape == (iters, R) and a.dtype == b.dtype
        assert torch.equal(a, b)
    if iters:
        assert bool(got[2][3].any())             # some swaps accepted


def test_sa_chains_kernel_rejects_bad_inputs(cuda):
    args, kw = _sa_case(cuda, "mesh:4x8", (), 24, 0.3, 4, 50, 64)
    (slots0, t0, cooling, other, vol, src, hops, e_src, e_dst,
     e_vol) = args
    i_all, j_all, u_all = kw["draws"]
    S = slots0.shape[1]

    def call(*a, draws=None, **extra):
        k = dict(kw, **extra)
        if draws is not None:
            k["draws"] = draws
        return sa_chains(*a, **k)
    before = sa_chains.launches
    with pytest.raises(TypeError):
        call(slots0.long(), *args[1:])
    with pytest.raises(TypeError):
        call(*args[:6], hops.double(), *args[7:])
    with pytest.raises(TypeError):
        call(*args, draws=(i_all.float(), j_all, u_all))
    with pytest.raises(ValueError):
        call(slots0, t0[:3], *args[2:])
    with pytest.raises(ValueError):
        call(*args, draws=(i_all[:10], j_all, u_all))
    with pytest.raises(ValueError):
        call(*args[:6], hops.cpu(), *args[7:])
    with pytest.raises(ValueError):
        call(*args[:6], hops.t(), *args[7:])
    with pytest.raises(ValueError, match="draws"):
        bad = i_all.clone()
        bad[3, 1] = S
        call(*args, draws=(bad, j_all, u_all))
    with pytest.raises(ValueError):
        call(*args[:3], other + 1, *args[4:])
    with pytest.raises(ValueError):
        call(*args, refresh_every=0)
    assert sa_chains.launches == before


# ---- LIF --------------------------------------------------------------------

# the reference kernel test's shapes, every LIF state shape of the Spike-VGG16
# training step at batch 8 (NCHW), odd sizes and a size above the grid cap
LIF_SHAPES = [(128,), (7, 13), (2, 9, 9, 8), (256, 128), (8, 64, 32, 32),
              (8, 128, 16, 16), (8, 256, 8, 8), (8, 512, 4, 4), (8, 512, 2, 2),
              (1,), (3,), (4099,), (1_000_003,)]


def _lif_inputs(shape, dtype, seed, device, offset=0):
    """u, s, I; ``offset`` > 0 slices the front off, so no pointer is
    16-byte aligned and the kernel takes its scalar path."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    raw = [rng.standard_normal(n + offset) * 1.5,
           (rng.random(n + offset) < 0.3),
           rng.standard_normal(n + offset)]
    return [torch.as_tensor(a.astype(np.float32), device=device)
            .to(dtype)[offset:].reshape(shape) for a in raw]


@pytest.mark.parametrize("shape", LIF_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_kernel_is_bit_identical_to_plain(cuda, shape, dtype, reset):
    u, s, c = _lif_inputs(shape, dtype, len(shape) * 13 + shape[-1], cuda)
    before = lif_step_kernel.launches
    un, sn = lif_step_kernel(u, s, c, reset=reset)
    torch.cuda.synchronize()
    assert lif_step_kernel.launches == before + 1
    ur, sr = lif_step_plain(u, s, c, reset=reset)
    assert un.dtype == dtype and un.shape == shape
    assert torch.equal(un, ur) and torch.equal(sn, sr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lif_kernel_unaligned_and_other_constants(cuda, dtype):
    u, s, c = _lif_inputs((4097,), dtype, 9, cuda, offset=1)
    assert u.data_ptr() % 16
    for reset in ("hard", "soft"):
        kw = dict(threshold=0.3, decay=0.9, reset=reset)
        un, sn = lif_step_kernel(u, s, c, **kw)
        torch.cuda.synchronize()
        ur, sr = lif_step_plain(u, s, c, **kw)
        assert torch.equal(un, ur) and torch.equal(sn, sr)


def test_lif_kernel_rejects_bad_inputs(cuda):
    u, s, c = _lif_inputs((4, 8), torch.float32, 0, cuda)
    before = lif_step_kernel.launches
    with pytest.raises(TypeError):
        lif_step_kernel(u.double(), s.double(), c.double())
    with pytest.raises(TypeError):
        lif_step_kernel(u, s.int(), c)
    with pytest.raises(ValueError):
        lif_step_kernel(u, s[:, :4], c)
    with pytest.raises(ValueError):
        lif_step_kernel(u.t(), s.t(), c.t())
    with pytest.raises(ValueError):
        lif_step_kernel(u, s.cpu(), c)
    with pytest.raises(ValueError):
        lif_step_kernel(u, s, c, reset="none")
    assert lif_step_kernel.launches == before


def _lif_grad_inputs(shape, dtype, seed, device, offset=0):
    """g_u, g_s, u, s, u' for one LIF backward (u' from the forward kernel
    on the same u, s and a random current); ``offset`` as in
    ``_lif_inputs``."""
    u, s, c = _lif_inputs(shape, dtype, seed, device, offset)
    rng = np.random.default_rng(seed + 1)
    n = int(np.prod(shape))
    gu, gs = (torch.as_tensor(rng.standard_normal(n + offset)
                              .astype(np.float32), device=device)
              .to(dtype)[offset:].reshape(shape) for _ in range(2))
    return gu, gs, u, s, lif_step_plain(u, s, c)[0]


def _same(got, want):
    return all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, want))


@pytest.mark.parametrize("shape", LIF_SHAPES)
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("alpha", [2.0, 3.0])
def test_lif_backward_kernel_is_bit_identical_to_plain(cuda, shape, reset,
                                                       alpha):
    """float32, rect surrogate, every cotangent present and every output
    asked for: d_u, d_s and g bit for bit the plain version's, at alpha 2
    (1 / alpha exact) and 3 (PyTorch may multiply by a rounded reciprocal
    where the kernel divides)."""
    args = _lif_grad_inputs(shape, torch.float32, len(shape) + shape[-1],
                            cuda)
    kw = dict(reset=reset, alpha=alpha)
    before = lif_backward_kernel.launches
    got = lif_backward_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert lif_backward_kernel.launches == before + 1
    want = lif_backward_plain(*args, **kw)
    assert all(a.dtype == torch.float32 and a.shape == shape for a in got)
    assert _same(got, want)


@pytest.mark.parametrize("present", ["both", "g_u", "g_s"])
@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True),
                                  (False, False)])
@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_backward_kernel_absent_inputs_unaligned(cuda, present, need,
                                                     reset):
    """Any cotangent absent, any of d_u / d_s skipped, 4097 elements off
    every 16-byte boundary (the scalar path) and 4099 aligned (the vector
    path and a tail), other constants: bit for bit the plain version."""
    kw = dict(threshold=0.3, decay=0.9, reset=reset, alpha=3.0,
              need_u=need[0], need_s=need[1])
    for n, offset in ((4097, 1), (4099, 0)):
        gu, gs, u, s, un = _lif_grad_inputs((n,), torch.float32, n, cuda,
                                            offset)
        assert (u.data_ptr() % 16 != 0) == bool(offset)
        cot = (gu if present != "g_s" else None,
               gs if present != "g_u" else None)
        before = lif_backward_kernel.launches
        got = lif_backward_kernel(*cot, u, s, un, **kw)
        torch.cuda.synchronize()
        launched = present != "g_u" or need[0] or need[1]
        assert lif_backward_kernel.launches == before + launched
        want = lif_backward_plain(*cot, u, s, un, **kw)
        assert _same(got, want)
        if present == "g_u":
            assert got[2] is gu


# float32 rect is bit-identical (above); the rest within their tolerance
TOLERANCE_CASES = [("sigmoid", torch.float32), ("atan", torch.float32),
                   ("rect", torch.bfloat16), ("sigmoid", torch.bfloat16),
                   ("atan", torch.bfloat16)]


@pytest.mark.parametrize("surrogate,dtype", TOLERANCE_CASES)
@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_backward_kernel_within_tolerance(cuda, surrogate, dtype, reset):
    """sigmoid and atan in float32 (expf and the divisions are not claimed
    bit-identical to PyTorch's kernels): rtol=1e-5, atol=1e-6; bfloat16,
    every surrogate (every intermediate rounded to bfloat16 as the plain
    version's operations round it, the constants in float32): within 2^-5
    of each result's largest magnitude."""
    args = _lif_grad_inputs((8, 64, 33), dtype, 21, cuda)
    kw = dict(reset=reset, surrogate=surrogate)
    got = lif_backward_kernel(*args, **kw)
    torch.cuda.synchronize()
    want = lif_backward_plain(*args, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            torch.testing.assert_close(
                a.float(), b.float(), rtol=0,
                atol=2**-5 * b.float().abs().max().item())


@pytest.mark.parametrize("dtypes", [(torch.float16,) * 5,
                                    (torch.bfloat16, torch.float32,
                                     torch.bfloat16, torch.float32,
                                     torch.float32)])
def test_lif_backward_kernel_mixed_dtypes_run_in_float32(cuda, dtypes):
    """float16 and mixed tensors: cast up exactly, computed in float32 and
    rounded once to the promoted dtype, bit for bit the plain version on
    the float32 casts."""
    args = [t.to(d) for t, d in zip(
        _lif_grad_inputs((8, 64, 33), torch.float32, 5, cuda), dtypes)]
    out = args[0].dtype
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    got = lif_backward_kernel(*args, reset="soft")
    torch.cuda.synchronize()
    want = lif_backward_plain(*(a.float() for a in args), reset="soft")
    assert all(a.dtype == out for a in got)
    assert _same(got, tuple(w.to(out) for w in want))


def test_lif_backward_kernel_rejects_bad_inputs(cuda):
    gu, gs, u, s, un = _lif_grad_inputs((4, 8), torch.float32, 0, cuda)
    before = lif_backward_kernel.launches
    with pytest.raises(TypeError):
        lif_backward_kernel(gu.double(), gs, u, s, un)
    with pytest.raises(ValueError):
        lif_backward_kernel(gu, gs[:, :4], u, s, un)
    with pytest.raises(ValueError):
        lif_backward_kernel(gu.t(), gs, u, s, un)
    with pytest.raises(ValueError):
        lif_backward_kernel(gu, gs.cpu(), u, s, un)
    with pytest.raises(ValueError):
        lif_backward_kernel(gu, gs, u, s, un, reset="none")
    with pytest.raises(ValueError):
        lif_backward_kernel(gu, gs, u, s, un, surrogate="relu")
    assert lif_backward_kernel.launches == before


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("surrogate", ["rect", "sigmoid", "atan"])
def test_lif_function_gradients_through_the_kernel(cuda, reset, surrogate,
                                                   monkeypatch):
    """``snn.neurons.lif_step`` over three timesteps through both LIF
    kernels (forward and backward, one launch each a step), and through
    both plain versions on the card: equal states, and gradients bit for
    bit with the rect surrogate, within the backward kernel's stated
    tolerance (rtol=1e-5, atol=1e-6) with sigmoid and atan."""
    from repro_torch.snn import neurons
    cfg = neurons.LIFConfig(reset=reset, surrogate=surrogate)
    cur = torch.as_tensor(np.random.default_rng(1).random((3, 8, 64, 16, 16),
                                                          np.float32) * 1.5,
                          device=cuda)
    g = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (8, 64, 16, 16)).astype(np.float32), device=cuda)

    def run():
        x = cur.clone().requires_grad_(True)
        u = torch.zeros_like(x[0])
        s = torch.zeros_like(x[0])
        for t in range(3):
            u, s = neurons.lif_step(u, s, x[t], cfg)
        (grad,) = torch.autograd.grad((s * g).sum() + u.sum(), x)
        return u.detach(), s.detach(), grad

    before = lif_step_kernel.launches, lif_backward_kernel.launches
    kernel = run()
    assert lif_step_kernel.launches == before[0] + 3
    assert lif_backward_kernel.launches == before[1] + 3
    monkeypatch.setattr(neurons, "_lif_forward", lif_step_plain)
    monkeypatch.setattr(neurons, "_lif_backward", lif_backward_plain)
    plain = run()
    assert lif_step_kernel.launches == before[0] + 3
    assert lif_backward_kernel.launches == before[1] + 3
    assert torch.equal(kernel[0], plain[0])
    assert torch.equal(kernel[1], plain[1])
    if surrogate == "rect":
        assert torch.equal(kernel[2], plain[2])
    else:
        torch.testing.assert_close(kernel[2], plain[2], rtol=1e-5, atol=1e-6)


# ---- spike matmul -------------------------------------------------------------

# the reference sweep, the im2col shapes of Spike-VGG16's twelve spiking
# convs at batch 8 (M = 8 H W, K = 9 Cin, N = Cout), and ragged edges
MM_SHAPES = [(32, 64, 16), (70, 200, 90), (128, 384, 256), (1, 128, 128),
             (8192, 576, 64), (2048, 576, 128), (2048, 1152, 128),
             (512, 1152, 256), (512, 2304, 256), (128, 2304, 512),
             (128, 4608, 512), (32, 4608, 512), (65, 17, 63)]


def _mm_close(got, want, spikes, w):
    """Within rtol=atol=1e-4 of the plain result, and within
    1e-4 + 1e-4 * (|spikes| @ |w|): the float32 error of two summation
    orders is bounded by a multiple of the sum of absolute terms."""
    err = (got.float() - want.float()).abs()
    scale = torch.matmul(spikes.float().abs(), w.float().abs())
    return bool((err <= 1e-4 + 1e-4 * want.float().abs()).all()
                and (err <= 1e-4 + 1e-4 * scale).all())


# weights "normal" as the convs' initial scale, "wide" log-uniform over
# 1e-3 ... 1e3 (positive, so |want| is the sum of absolute terms and both
# bounds of _mm_close read the same: a single bf16 pass, off by up to 2^-9
# of each weight, fails it; the kernel's hi + lo split, 2^-17, must pass);
# spikes "binary" or "multi", values from {0, 0.5, 1, 2}, which bf16
# represents exactly
MM_CASES = [(m, k, n, d, "normal", "binary") for m, k, n in MM_SHAPES
            for d in (0.0, 0.15, 1.0)] + [
    (m, k, n, d, "wide", "binary") for m, k, n in
    [(128, 4608, 512), (32, 4608, 512), (70, 200, 90), (8192, 576, 64)]
    for d in (0.15, 1.0)] + [
    (m, k, n, 0.3, "normal", "multi") for m, k, n in
    [(128, 2304, 512), (65, 17, 63), (2048, 576, 128)]]


def _mm_weights(rng, k, n, kind):
    if kind == "wide":
        return (10.0 ** rng.uniform(-3, 3, (k, n))).astype(np.float32)
    return (rng.standard_normal((k, n)) / np.sqrt(3)).astype(np.float32)


@pytest.mark.parametrize("m,k,n,density,weights,values", MM_CASES)
def test_spike_matmul_kernel_matches_plain(cuda, m, k, n, density, weights,
                                           values):
    from repro_torch.kernels.spike_matmul import zero_tiles
    rng = np.random.default_rng(m + k + n)
    sp = (rng.random((m, k)) < density).astype(np.float32)
    if values == "multi":
        sp *= rng.choice([0.5, 1.0, 2.0], (m, k)).astype(np.float32)
    sp = torch.as_tensor(sp, device=cuda)
    w = torch.as_tensor(_mm_weights(rng, k, n, weights), device=cuda)
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = spike_matmul_kernel.launches
    got = spike_matmul_kernel(sp, w, skipped=skipped)
    torch.cuda.synchronize()
    assert spike_matmul_kernel.launches == before + 1
    assert int(skipped.item()) == zero_tiles(sp, n)
    want = spike_matmul_plain(sp, w)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _mm_close(got, want, sp, w)
    if density == 0.0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("m,k,n", [(32, 4608, 512), (128, 4608, 512)])
def test_spike_matmul_kernel_split_k_is_deterministic(cuda, m, k, n):
    """K split across blocks (the deep VGG16 layers): the partial tiles are
    summed in a fixed order, so repeated calls agree bit for bit."""
    from repro_torch.kernels.spike_matmul import splits
    assert splits(m, k, n)[0] > 1
    rng = np.random.default_rng(7)
    sp = torch.as_tensor((rng.random((m, k)) < 0.2).astype(np.float32),
                         device=cuda)
    w = torch.as_tensor(_mm_weights(rng, k, n, "normal"), device=cuda)
    first = spike_matmul_kernel(sp, w)
    for _ in range(5):
        assert torch.equal(spike_matmul_kernel(sp, w), first)
    assert _mm_close(first, spike_matmul_plain(sp, w), sp, w)


def test_spike_matmul_kernel_skips_silent_channels(cuda):
    """75% of the input channels silent, as im2col lays them out
    ([Cin, kh, kw] per row): whole spike tiles are zero and skipped."""
    from repro_torch.kernels.spike_matmul import zero_tiles
    rng = np.random.default_rng(5)
    sp = (rng.random((512, 256, 9)) < 0.2).astype(np.float32)
    sp[:, rng.permutation(256)[:192]] = 0.0
    sp = torch.as_tensor(sp.reshape(512, 2304), device=cuda)
    w = torch.as_tensor(rng.standard_normal((2304, 256)).astype(np.float32),
                        device=cuda)
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = spike_matmul_kernel(sp, w, skipped=skipped)
    torch.cuda.synchronize()
    assert int(skipped.item()) == zero_tiles(sp, 256) > 0
    assert _mm_close(got, spike_matmul_plain(sp, w), sp, w)


def test_spike_matmul_kernel_bf16(cuda):
    rng = np.random.default_rng(4)
    sp = torch.as_tensor((rng.random((64, 128)) < 0.2).astype(np.float32),
                         device=cuda).bfloat16()
    w = torch.as_tensor(rng.standard_normal((128, 64)).astype(np.float32),
                        device=cuda).bfloat16()
    got = spike_matmul_kernel(sp, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    want = spike_matmul_plain(sp, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


def test_spike_matmul_kernel_rejects_bad_inputs(cuda):
    sp = torch.zeros(8, 16, device=cuda)
    w = torch.zeros(16, 4, device=cuda)
    before = spike_matmul_kernel.launches
    with pytest.raises(TypeError):
        spike_matmul_kernel(sp, w.int())
    with pytest.raises(TypeError):
        spike_matmul_kernel(sp.double(), w.double())
    with pytest.raises(ValueError):
        spike_matmul_kernel(sp, w[:8])
    with pytest.raises(ValueError):
        spike_matmul_kernel(sp.t(), torch.zeros(8, 4, device=cuda))
    with pytest.raises(ValueError):
        spike_matmul_kernel(sp, w.cpu())
    with pytest.raises(ValueError):
        spike_matmul_kernel(sp, w, skipped=torch.zeros(1, device=cuda))
    assert spike_matmul_kernel.launches == before


@pytest.mark.parametrize("stride", [1, 2])
def test_spike_conv_matches_fp32_conv_on_the_card(cuda, stride):
    from repro_torch.kernels import ops
    from repro_torch.snn import layers
    rng = np.random.default_rng(stride)
    sp = torch.as_tensor((rng.random((8, 15, 15, 32)) < 0.2)
                         .astype(np.float32), device=cuda)
    w = torch.as_tensor(rng.standard_normal((3, 3, 32, 48))
                        .astype(np.float32), device=cuda)
    before = spike_matmul_kernel.launches
    got = ops.spike_conv(sp, w, stride)
    torch.cuda.synchronize()
    assert spike_matmul_kernel.launches == before + 1
    with layers.fp32_convs():
        want = layers.conv2d({"w": w.permute(3, 2, 0, 1).contiguous()},
                             sp.permute(0, 3, 1, 2).contiguous(), stride)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-4,
                               atol=1e-4)


# ---- the training step and the PPO scorer -----------------------------------

def test_vgg16_train_step_kernel_path_is_bit_identical_to_plain(cuda,
                                                                monkeypatch):
    """One full-width Spike-VGG16 training step (batch 8, T=4) through the
    LIF kernels (forward and backward) and through their plain versions on
    the card, deterministic cuDNN: the same loss and the same gradient, bit
    for bit."""
    from repro_torch.snn import bptt, models, neurons
    cfg = models.spike_vgg16()
    net = models.init_model(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((8, 32, 32, 3), np.float32), device=cuda)
    y = torch.as_tensor(rng.integers(0, 10, 8), device=cuda)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    before = lif_step_kernel.launches, lif_backward_kernel.launches
    kernel = bptt.loss_and_grads(net, cfg, x, y)
    torch.cuda.synchronize()
    assert lif_step_kernel.launches == before[0] + 13 * cfg.T
    assert lif_backward_kernel.launches == before[1] + 13 * cfg.T
    monkeypatch.setattr(neurons, "_lif_forward", lif_step_plain)
    monkeypatch.setattr(neurons, "_lif_backward", lif_backward_plain)
    plain = bptt.loss_and_grads(net, cfg, x, y)
    assert lif_step_kernel.launches == before[0] + 13 * cfg.T
    assert lif_backward_kernel.launches == before[1] + 13 * cfg.T
    for a, b in zip(kernel[:3], plain[:3]):
        assert torch.equal(a, b)
    for (name, _), a, b in zip(net.named_parameters(), kernel[3], plain[3]):
        assert torch.equal(a, b), name


def test_ppo_with_a_cfg_scores_on_the_card_by_default(cuda):
    """``optimize_placement(method="ppo", cfg=PPOConfig(...))`` with no
    backend scores its rollouts through the link-traffic kernel that
    gathers the routes itself (once an iteration), and never through the
    unfused one."""
    from repro_torch.core.graph import random_dag
    from repro_torch.core.placement import PPOConfig, optimize_placement
    before = link_traffic_routes.launches, link_traffic.launches
    res = optimize_placement(random_dag(16, seed=0), NoC(4, 4),
                             method="ppo", objective="latency",
                             cfg=PPOConfig(batch_size=32, iterations=2))
    assert link_traffic_routes.launches == before[0] + 2
    assert link_traffic.launches == before[1]
    assert len(res.history) == 2


def test_policy_on_the_card_scores_through_the_route_kernel(cuda):
    """The policy baseline on the card: a link-level objective launches the
    fused link-traffic kernel once an iteration, its best cost is the host
    evaluate's (float32 scoring, rtol 1e-5), and its placements are
    injective."""
    from repro_torch.core.graph import random_dag
    from repro_torch.core.placement import optimize_placement
    from repro_torch.deploy import as_objective
    g, noc = random_dag(16, seed=0), NoC(4, 4)
    g.adj[:] = np.round(g.adj)
    before = link_traffic_routes.launches, link_traffic.launches
    res = optimize_placement(g, noc, method="policy", objective="latency",
                             budget=3, batch_size=32)
    assert link_traffic_routes.launches == before[0] + 3
    assert link_traffic.launches == before[1]
    assert len(set(res.placement.tolist())) == g.n
    host = as_objective("latency").from_metrics(
        noc.evaluate(g, res.placement), noc)
    np.testing.assert_allclose(res.history[-1]["best_cost"], host,
                               rtol=1e-5)


def test_device_resolver_on_the_card_is_exact(cuda):
    """The collision resolver on the card against the numpy resolver at the
    PPO path's shape (256 rollouts of 64 nodes on 8x8), with a full and a
    partial priority order."""
    from repro_torch.core.placement.discretize_batch import (
        continuous_to_grid_batch, make_torch_resolver,
        resolve_collisions_batch)
    rng = np.random.default_rng(0)
    cells = continuous_to_grid_batch(rng.normal(0, 0.6, (256, 64, 2)), 8, 8)
    prio = rng.permutation(64)
    for p in (None, prio, prio[:40]):
        got = make_torch_resolver(8, 8, p)(cells)
        assert got.is_cuda
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      resolve_collisions_batch(cells, 8, 8, p))


@pytest.mark.parametrize("method", ["simulated_annealing", "random_search"])
def test_fused_service_searches_match_serial_on_the_card(cuda, method):
    """Cold requests fused into one batched float32 scorer call on the card
    give every row its serial search's plan, bit for bit."""
    from repro_torch.deploy import DeployRequest, PlacementService
    from repro_torch.deploy import execute_request
    from repro_torch.snn import spike_resnet18
    for objective in ("comm_cost", "max_link"):
        reqs = [DeployRequest.from_call(
            spike_resnet18(n_classes=10, in_res=32, T=4), NoC(4, 4),
            method=method, objective=objective, schedule="none", budget=300,
            seed=s) for s in (1, 2, 3)]
        resps = PlacementService().submit_batch(reqs)
        assert all(r.fused and r.status == "miss" for r in resps)
        for req, resp in zip(reqs, resps):
            solo = execute_request(req)
            assert resp.placement == solo.placement.placement.tolist()
            assert resp.objective_cost == solo.placement.objective_cost


# ---- flash attention and the token server --------------------------------------

# (B, H, Hkv, S, D, window, dtype, causal): the reference sweep's shapes
# (tests/test_kernels.py) with and without a window, its bf16 case, S off
# the 64-row tile, D = 256, non-causal input, and the served shapes; then
# the bf16 tensor-core kernel over its D buckets (16 ... 256, and D = 20,
# not a multiple of 8, through its element-wise loads), S = 1, 77, 200 and
# 4608, windows of 37 and of 4096 past S, non-causal input and GQA with 1,
# 2 and 4 q heads per kv head
FLASH_CASES = [(2, h, hkv, s, d, w, torch.float32, True)
               for s, d, h, hkv in [(128, 64, 4, 4), (160, 48, 4, 2),
                                    (256, 128, 2, 1)]
               for w in (None, 37)] + [
    (1, 2, 2, 128, 64, None, torch.bfloat16, True),
    (2, 4, 2, 200, 80, 50, torch.float32, True),
    (1, 3, 1, 77, 16, 5, torch.bfloat16, True),
    (3, 2, 2, 1, 8, None, torch.float32, True),
    (2, 4, 2, 200, 256, None, torch.float32, True),
    (2, 4, 2, 192, 32, None, torch.float32, False),
    (2, 4, 2, 130, 64, 20, torch.float32, False),
    (4, 16, 8, 2048, 128, None, torch.bfloat16, True),
    (1, 32, 8, 4608, 80, 4096, torch.bfloat16, True),
    (2, 4, 4, 200, 16, None, torch.bfloat16, True),
    (2, 4, 2, 77, 48, 37, torch.bfloat16, True),
    (1, 8, 2, 200, 96, None, torch.bfloat16, False),
    (2, 4, 1, 1, 128, None, torch.bfloat16, True),
    (1, 4, 1, 1, 16, 37, torch.bfloat16, True),
    (2, 4, 2, 200, 80, 4096, torch.bfloat16, True),
    (1, 4, 2, 200, 256, 37, torch.bfloat16, True),
    (1, 2, 2, 77, 256, None, torch.bfloat16, False),
    (1, 4, 1, 4608, 128, 4096, torch.bfloat16, True),
    (1, 2, 1, 77, 20, None, torch.bfloat16, True),
    (2, 4, 2, 130, 64, 20, torch.bfloat16, False),
    # the served MLA and MoE prefills: minicpm3-4b (q/k head dim 96, MHA),
    # qwen3-moe-30b-a3b (D 128, 32/4 heads), deepseek-v3-671b (D 192, MHA)
    (4, 40, 40, 2048, 96, None, torch.bfloat16, True),
    (4, 32, 4, 2048, 128, None, torch.bfloat16, True),
    (4, 128, 128, 2048, 192, None, torch.bfloat16, True),
    # zamba2-2.7b's shared attention block: head dim 5120 / 32 = 160, MHA
    (4, 32, 32, 2048, 160, None, torch.bfloat16, True),
    (1, 4, 2, 200, 160, 37, torch.bfloat16, True),
    # seamless-m4t-medium's encoder and equal-length cross-attention: D 64,
    # MHA, non-causal, at the served prefill and off the tile
    (4, 16, 16, 2048, 64, None, torch.bfloat16, False),
    (2, 16, 16, 77, 64, None, torch.bfloat16, False),
]


def _flash_inputs(dev, b, h, hkv, s, d, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=gen, device=dev) * 0.5
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev) * 0.5
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    return tuple(t.to(dtype) for t in (q, k, v))


@pytest.mark.parametrize("b,h,hkv,s,d,window,dtype,causal", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, h, hkv, s, d, window,
                                              dtype, causal):
    """float32 within rtol=atol=1e-5 (the same float32 softmax, sums in
    another order); bfloat16 within 1e-2 (about two roundings of the
    output). bfloat16 goes through the tensor-core kernel, float32 does
    not."""
    q, k, v = _flash_inputs(cuda, b, h, hkv, s, d, dtype)
    before = flash_attention_kernel.launches
    tc_before = flash_attention_kernel.tensor_core_launches
    got = flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert (flash_attention_kernel.tensor_core_launches
            == tc_before + (dtype == torch.bfloat16))
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 0),
                                          (torch.bfloat16, 0),
                                          (torch.bfloat16, 1)])
def test_flash_attention_kernel_reads_and_writes_strided_views(cuda, dtype,
                                                               offset):
    """BSHD tensors go in as ``transpose(1, 2)`` views and the result lands
    in a strided ``out``, as the model's attention hands them over; with
    ``offset`` 1 every view starts one element off 16 bytes, so the
    bf16 kernel takes its element-wise loads and stores."""
    def view(t):
        b, h, s, d = t.shape
        base = torch.empty(b * s * h * d + offset, dtype=dtype, device=cuda)
        bshd = base[offset:].view(b, s, h, d)
        bshd.copy_(t.transpose(1, 2))
        return bshd.transpose(1, 2)

    q, k, v = (view(t) for t in _flash_inputs(cuda, 2, 8, 2, 100, 64, dtype))
    assert not q.is_contiguous()
    out = view(torch.zeros(2, 8, 100, 64, dtype=dtype, device=cuda))
    got = flash_attention_kernel(q, k, v, window=30, out=out)
    torch.cuda.synchronize()
    assert got is out
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=30)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_rejects_bad_inputs(cuda):
    q, k, v = _flash_inputs(cuda, 1, 4, 2, 64, 32, torch.float32)
    with pytest.raises(TypeError):
        flash_attention_kernel(q.double(), k, v)
    with pytest.raises(TypeError):
        flash_attention_kernel(q, k.int(), v.int())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 4, 64, 288, device=cuda)
        flash_attention_kernel(big, big[:, :2], big[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(q.transpose(2, 3), k.transpose(2, 3),
                               v.transpose(2, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_kernel(q, k.cpu(), v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_kernel(q, k[:, :1].expand(1, 3, 64, 32).contiguous(),
                               v[:, :1].expand(1, 3, 64, 32).contiguous())


@pytest.mark.parametrize("window", [None, 37])
def test_attention_gradients_on_the_card_match_the_cpu(cuda, window):
    """q/k/v that require grad take the kernel route on the card: one flash
    forward launch (writing lse) and one backward call; the gradients match
    the CPU's (the reference's custom VJP in plain torch) within
    rtol=atol=1e-4 (float32, sums in another order). Without grad the same
    call launches only the forward kernel."""
    from repro_torch.models import layers
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in _flash_inputs(cuda, 2, 8, 4, 96, 32, torch.float32))
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                    .manual_seed(1), device=cuda)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = (flash_attention_kernel.launches,
                  flash_attention_backward_kernel.launches)
        out = layers.blockwise_attention(*leaves, window=window, q_chunk=32,
                                         k_chunk=32)
        (out * g.to(dev)).sum().backward()
        on_card = int(dev.type == "cuda")
        assert (flash_attention_kernel.launches,
                flash_attention_backward_kernel.launches) == (
                    before[0] + on_card, before[1] + on_card)
        grads[dev.type] = [out.detach().cpu()] + [t.grad.cpu()
                                                  for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    before = (flash_attention_kernel.launches,
              flash_attention_backward_kernel.launches)
    with torch.no_grad():
        out = layers.blockwise_attention(q.requires_grad_(), k, v,
                                         window=window)
    assert (flash_attention_kernel.launches,
            flash_attention_backward_kernel.launches) == (before[0] + 1,
                                                          before[1])
    torch.testing.assert_close(out.cpu(), grads["cpu"][0], rtol=1e-4,
                               atol=1e-4)


# (b, h, hkv, s, d, window, dtype, causal): the trained internlm2 layer's
# heads at a shorter S, h2o-danube's D 80 and window, the smoke configs'
# float32 shape, odd S and D, D 256, GQA 1/2/4, non-causal input, and the
# bf16 tensor-core route past D 128 over its buckets
FLASH_BWD_CASES = [
    (2, 16, 8, 512, 128, None, torch.bfloat16, True),
    (1, 8, 2, 300, 80, 100, torch.bfloat16, True),
    (2, 4, 2, 40, 16, None, torch.float32, True),
    (2, 4, 2, 40, 16, 24, torch.float32, True),
    (1, 4, 1, 77, 20, None, torch.float32, True),
    (1, 4, 4, 77, 20, 5, torch.bfloat16, True),
    (2, 4, 2, 130, 48, None, torch.float32, False),
    (1, 4, 2, 100, 256, 37, torch.float32, True),
    (1, 2, 1, 65, 256, None, torch.bfloat16, True),
    (2, 8, 2, 1, 64, None, torch.float32, True),
    # zamba2-2.7b's shared block (D 160): bf16 past D 128 on the wide
    # tensor-core kernels
    (1, 32, 32, 1024, 160, None, torch.bfloat16, True),
    (1, 4, 2, 200, 160, 37, torch.bfloat16, True),
    (1, 4, 2, 77, 160, None, torch.float32, True),
    # seamless-m4t-medium (D 64, MHA) on the tensor cores: non-causal (the
    # encoder, equal-length cross-attention; every q tile feeds every kv
    # tile) and causal (the decoder's self-attention)
    (2, 16, 16, 1024, 64, None, torch.bfloat16, False),
    (2, 16, 16, 77, 64, None, torch.bfloat16, False),
    (2, 16, 16, 1024, 64, None, torch.bfloat16, True),
    # the trained MLA/MoE layers: minicpm3-4b's MLA (D 96, MHA) on the
    # tensor cores, qwen3-moe's GQA 32/4 at D 128, deepseek-v3's MLA (D 192)
    # past D 128 on the wide tensor-core kernels
    (1, 8, 8, 300, 96, None, torch.bfloat16, True),
    (2, 32, 4, 512, 128, None, torch.bfloat16, True),
    (1, 8, 8, 257, 192, None, torch.bfloat16, True),
    # the wide route: D 130 (not a multiple of 8: element-wise loads), 136,
    # 200, 224 and 256 under causal, non-causal and windowed masks; GQA 4:1
    # at D 192; S = 1 and S = 65 (one row past a 64-row tile)
    (1, 4, 2, 200, 130, None, torch.bfloat16, True),
    (1, 4, 4, 150, 130, 33, torch.bfloat16, False),
    (2, 4, 2, 300, 136, 50, torch.bfloat16, True),
    (1, 4, 2, 130, 200, None, torch.bfloat16, False),
    (1, 8, 8, 257, 224, 100, torch.bfloat16, True),
    (1, 4, 2, 333, 256, None, torch.bfloat16, True),
    (1, 4, 1, 200, 256, 37, torch.bfloat16, False),
    (2, 16, 4, 512, 192, None, torch.bfloat16, True),
    (2, 8, 2, 1, 192, None, torch.bfloat16, True),
    (1, 4, 2, 65, 160, None, torch.bfloat16, True),
    (1, 4, 2, 65, 224, 7, torch.bfloat16, False),
    # the wgmma route up to D 128 (D a multiple of 8, 16-byte aligned; the
    # trained shapes above at D 64, 80, 96 and 128 take it too): D 32 and
    # S = 65, 40 heads at D 96, GQA 8:1 at D 128, a window at D 64, S = 1,
    # D 96 non-causal at S = 77
    (1, 4, 2, 65, 32, None, torch.bfloat16, True),
    (1, 40, 40, 200, 96, None, torch.bfloat16, True),
    (1, 16, 2, 333, 128, None, torch.bfloat16, True),
    (2, 4, 2, 300, 64, 50, torch.bfloat16, True),
    (2, 8, 2, 1, 128, None, torch.bfloat16, True),
    (1, 4, 4, 77, 96, None, torch.bfloat16, False),
]


def _bwd_inputs(dev, b, h, hkv, s, d, window, dtype, causal, seed=0):
    q, k, v = _flash_inputs(dev, b, h, hkv, s, d, dtype, seed)
    lse = torch.empty(b, h, s, device=dev)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 lse=lse)
    dout = torch.randn(q.shape, generator=torch.Generator(device=dev)
                       .manual_seed(seed + 1), device=dev).to(dtype)
    return q, k, v, out, dout, lse


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("b,h,hkv,s,d,window,dtype,causal", FLASH_BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain(cuda, b, h, hkv, s, d,
                                                       window, dtype, causal):
    """float32 within 1e-4 of each gradient's largest magnitude (float32
    sums in another order), plus 1e-5 absolute where a gradient is zero up
    to rounding (S = 1: ds = p (dp - delta) cancels exactly, leaving
    float32 noise of the size eps |dp| scale); bfloat16 within relative L2
    2e-2 per gradient (bf16 products with float32 sums, P and dS rounded
    to bf16 as operands, one rounding of each result), but at S = 1, where
    each row sees itself alone (p = 1, dp = delta) and dq, dk cancel to
    rounding in both versions, those two are held to the float32 bound. A
    second call is bit-identical (no atomics); a bf16 call is one
    tensor-core launch, up to D 128 with D a multiple of 8 one wgmma
    launch."""
    fn = flash_attention_backward_kernel
    args = _bwd_inputs(cuda, b, h, hkv, s, d, window, dtype, causal)
    before = (fn.launches, fn.tensor_core_launches, fn.wgmma_launches)
    got = flash_attention_backward_kernel(*args, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (fn.launches, fn.tensor_core_launches, fn.wgmma_launches) == (
        before[0] + 1, before[1] + int(bf16),
        before[2] + int(bf16 and d <= 128 and d % 8 == 0))
    again = flash_attention_backward_kernel(*args, causal=causal,
                                            window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_backward_plain(*args, causal=causal,
                                          window=window)
    for i, (g, w, like) in enumerate(zip(got, want, args[:3])):
        assert g.dtype == like.dtype and g.shape == like.shape
        assert bool(torch.isfinite(g.float()).all())
        if dtype == torch.float32 or (s == 1 and i < 2):
            bound = 1e-4 * w.abs().max().item() + 1e-5
            assert (g.float() - w.float()).abs().max().item() <= bound
        else:
            assert _rel_l2(g, w) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_forward_lse_matches_plain(cuda, dtype):
    """The forward's lse within 1e-5 of the plain version's in float32 and
    1e-4 in bfloat16 (the tensor-core kernel keeps m in log2 units); with
    and without lse the output is bit-identical."""
    for b, h, hkv, s, d, window in [(2, 4, 2, 200, 80, 50),
                                    (1, 16, 8, 512, 128, None),
                                    (1, 3, 1, 77, 20, 5)]:
        q, k, v = _flash_inputs(cuda, b, h, hkv, s, d, dtype)
        lse = torch.full((b, h, s), float("nan"), device=cuda)
        out = flash_attention_kernel(q, k, v, window=window, lse=lse)
        plain = torch.empty_like(lse)
        flash_attention_plain(q, k, v, window=window, lse=plain)
        tol = 1e-5 if dtype == torch.float32 else 1e-4
        torch.testing.assert_close(lse, plain, rtol=tol, atol=tol)
        assert torch.equal(out, flash_attention_kernel(q, k, v,
                                                       window=window))


@pytest.mark.parametrize("dtype,d,window", [
    (torch.float32, 64, 40), (torch.bfloat16, 64, 40),
    (torch.bfloat16, 96, None), (torch.bfloat16, 128, 40),
    (torch.bfloat16, 192, None), (torch.bfloat16, 130, 40)])
def test_flash_attention_backward_kernel_strided_and_repeatable(cuda, dtype,
                                                                d, window):
    """BSHD views in and out, as the model's Function hands them over, GQA
    4:1 (at D 64, 96 and 128 the wgmma route, its TMA maps built from the
    views' strides; at D 192 and D 130 the wide tensor-core route, with
    16-byte copies and with element-wise loads); two calls give
    bit-identical gradients (no atomics), each bf16 call one tensor-core
    launch, up to D 128 one wgmma launch."""
    def view(t):
        return t.transpose(1, 2).contiguous().transpose(1, 2)

    *tensors, lse = _bwd_inputs(cuda, 2, 8, 2, 150, d, window, dtype, True)
    args = [view(t) for t in tensors]
    assert not args[0].is_contiguous()
    grads = [view(torch.zeros_like(t)) for t in args[:3]]
    fn = flash_attention_backward_kernel
    before = (fn.tensor_core_launches, fn.wgmma_launches)
    got = flash_attention_backward_kernel(*args, lse, window=window,
                                          dq=grads[0], dk=grads[1],
                                          dv=grads[2])
    assert all(a is b for a, b in zip(got, grads))
    again = flash_attention_backward_kernel(*args, lse, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bf16 = dtype == torch.bfloat16
    assert (fn.tensor_core_launches, fn.wgmma_launches) == (
        before[0] + 2 * int(bf16), before[1] + 2 * int(bf16 and d <= 128))
    want = flash_attention_backward_plain(*(t.contiguous() for t in args),
                                          lse, window=window)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_backward_kernel_off_16_bytes_keeps_mma(cuda, d):
    """bf16 inputs TMA cannot read (q, k, v and dO two bytes off a 16-byte
    boundary) take the mma.sync kernels up to D 128: one tensor-core launch
    and no wgmma launch, within relative L2 2e-2 of the plain version."""
    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    q, k, v, out, dout, lse = _bwd_inputs(cuda, 1, 4, 2, 150, d, None,
                                          torch.bfloat16, True)
    args = [shifted(t) for t in (q, k, v, out, dout)]
    assert args[0].data_ptr() % 16 != 0
    fn = flash_attention_backward_kernel
    before = (fn.tensor_core_launches, fn.wgmma_launches)
    got = flash_attention_backward_kernel(*args, lse)
    torch.cuda.synchronize()
    assert (fn.tensor_core_launches, fn.wgmma_launches) == (before[0] + 1,
                                                            before[1])
    want = flash_attention_backward_plain(q, k, v, out, dout, lse)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= 2e-2


def test_flash_attention_backward_kernel_rejects_bad_inputs(cuda):
    q, k, v, out, dout, lse = _bwd_inputs(cuda, 1, 4, 2, 64, 32, None,
                                          torch.float32, True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward_kernel(q, k, v, out, dout, None)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward_kernel(q, k, v, out, dout, lse.double())
    with pytest.raises(ValueError, match="dout"):
        flash_attention_backward_kernel(q, k, v, out, dout[:, :2], lse)
    with pytest.raises(TypeError):
        flash_attention_backward_kernel(q.double(), k, v, out.double(),
                                        dout, lse)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_backward_kernel(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v, out, dout,
            lse)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_backward_kernel(q, k.cpu(), v, out, dout, lse)
    with pytest.raises(ValueError, match="dk"):
        flash_attention_backward_kernel(q, k, v, out, dout, lse,
                                        dk=torch.empty_like(q))


def _attention_layers(cfg) -> int:
    """Causal self-attentions a forward runs: the attention and MLA layers,
    and each application of a hybrid model's shared block."""
    n = sum(s.count for s in cfg.segments if s.kind in ("attn", "mla"))
    return n + (cfg.n_layers // cfg.hybrid_period if cfg.hybrid_period
                else 0)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b",
                                  "zamba2-2.7b", "minicpm3-4b",
                                  "qwen3-moe-30b-a3b", "deepseek-v3-671b"])
def test_lm_loss_gradients_on_the_card_match_the_cpu(cuda, arch):
    """A smoke-size model's loss and every gradient leaf on the card
    (remat "full", chunked CE; each layer's attention through the flash
    forward and backward kernels, float32; deepseek's MTP layer too, once,
    outside remat) against the same model on the CPU (the reference's
    custom VJP in plain torch): loss within rtol 1e-5, gradients within
    rtol 1e-4 / atol 1e-6 of float32 sums in another order (zamba2: atol
    1e-5 of each leaf's largest magnitude)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, tree_leaves, tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full",
                              logit_chunk=8)
    cpu = materialize(lm.lm_specs(cfg), torch.Generator().manual_seed(0),
                      device="cpu")
    rng = np.random.default_rng(0)
    s = 64 if cfg.ssm is not None else 48      # zamba2: SSD chunks of 32
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, s)))
    labels = torch.as_tensor(rng.integers(-1, cfg.vocab, (2, s)))
    n_attn = _attention_layers(cfg)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev).requires_grad_(), cpu)
        leaves = [t for _, t in tree_leaves(params)]
        before = (flash_attention_kernel.launches,
                  flash_attention_backward_kernel.launches)
        loss, _ = lm.lm_loss(params, cfg, toks.to(dev), labels.to(dev))
        grads = torch.autograd.grad(loss, leaves)
        on_card = int(dev.type == "cuda")
        assert (flash_attention_kernel.launches,
                flash_attention_backward_kernel.launches) == (
                    before[0] + (2 * n_attn + cfg.mtp) * on_card,
                    before[1] + (n_attn + cfg.mtp) * on_card)
        res[dev.type] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-5,
                               atol=0)
    # zamba2's gradients pass through 6 blocks and the SSD recurrence:
    # within rtol 1e-4 plus 1e-5 of each leaf's largest magnitude, as
    # tests/test_torch_train.py holds them against the reference
    share = 1e-5 if cfg.ssm is not None else 0.0
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=max(1e-6, share * b.abs().max().item()))


@pytest.mark.parametrize("s_enc,s_dec", [(32, 32), (40, 24)])
def test_encdec_loss_gradients_on_the_card_match_the_cpu(cuda, s_enc,
                                                         s_dec):
    """seamless-m4t-medium's smoke model with float32 weights (a subclass:
    dtype is a class attribute) on the card against the CPU, loss within
    rtol 1e-5 and every gradient within rtol 1e-4 / atol 1e-6, remat
    "full", chunked CE. The encoder's attention runs the flash kernels
    non-causal, the decoder's self-attention causal, and cross-attention
    non-causal where ``S_dec == S_enc`` (else the chunked ``_Flash``):
    forward launches twice each under remat, one backward call each."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encdec
    from repro_torch.models.specs import materialize, tree_leaves, tree_map

    class F32(encdec.EncDecConfig):
        dtype = param_dtype = torch.float32

    smoke = get_smoke_config("seamless-m4t-medium")
    cfg = F32(**{f.name: getattr(smoke, f.name)
                 for f in dataclasses.fields(smoke)})
    cfg = dataclasses.replace(cfg, remat="full", logit_chunk=8)
    cpu = materialize(encdec.encdec_specs(cfg),
                      torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.standard_normal((2, s_enc, cfg.d_model)),
                             dtype=torch.float32)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, s_dec)))
    labels = torch.as_tensor(rng.integers(-1, cfg.vocab, (2, s_dec)))
    n_attn = cfg.n_enc_layers + cfg.n_dec_layers * (1 + (s_enc == s_dec))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev).requires_grad_(), cpu)
        leaves = [t for _, t in tree_leaves(params)]
        before = (flash_attention_kernel.launches,
                  flash_attention_backward_kernel.launches)
        loss, _ = encdec.encdec_loss(params, cfg, frames.to(dev),
                                     toks.to(dev), labels.to(dev))
        grads = torch.autograd.grad(loss, leaves)
        on_card = int(dev.type == "cuda")
        assert (flash_attention_kernel.launches,
                flash_attention_backward_kernel.launches) == (
                    before[0] + 2 * n_attn * on_card,
                    before[1] + n_attn * on_card)
        res[dev.type] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-5,
                               atol=0)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# float16 and mixed inputs: (u, s, current) dtypes for LIF, (spikes, w) for
# spike_matmul, (q, k, v) for flash
F16, BF16, F32 = torch.float16, torch.bfloat16, torch.float32
MIXED_LIF = [(F16, F16, F16), (BF16, F32, F32), (F32, BF16, F16),
             (F16, BF16, F32)]
MIXED_MM = [(F16, F16), (BF16, F32), (F32, BF16), (F32, F16)]
MIXED_FLASH = [(F16, F16, F16), (BF16, F32, F32), (F32, BF16, BF16),
               (F16, F32, BF16)]


@pytest.mark.parametrize("dtypes", MIXED_LIF)
def test_lif_kernel_mixed_dtypes_are_bit_identical_to_plain(cuda, dtypes):
    """Run in float32 (every input cast up exactly), rounded once to
    ``u.dtype``: bit for bit the plain version, which does the same."""
    u, s, c = (t.to(d) for t, d in zip(
        _lif_inputs((8, 64, 33), F32, 3, cuda), dtypes))
    before = lif_step_kernel.launches
    un, sn = lif_step_kernel(u, s, c, reset="soft")
    torch.cuda.synchronize()
    assert lif_step_kernel.launches == before + 1
    ur, sr = lif_step_plain(u, s, c, reset="soft")
    assert un.dtype == sn.dtype == dtypes[0]
    assert torch.equal(un, ur) and torch.equal(sn, sr)


@pytest.mark.parametrize("sd,wd", MIXED_MM)
def test_spike_matmul_kernel_mixed_dtypes_match_plain(cuda, sd, wd):
    """float32 kernel on exact float32 copies, the result in ``w.dtype``:
    within this file's float32 bounds, or one rounding (1e-2) of a
    half-width ``w``."""
    rng = np.random.default_rng(8)
    sp = torch.as_tensor((rng.random((300, 576)) < 0.2).astype(np.float32),
                         device=cuda).to(sd)
    w = torch.as_tensor(rng.standard_normal((576, 64)).astype(np.float32),
                        device=cuda).to(wd)
    before = spike_matmul_kernel.launches
    got = spike_matmul_kernel(sp, w)
    torch.cuda.synchronize()
    assert spike_matmul_kernel.launches == before + 1
    want = spike_matmul_plain(sp, w)
    assert got.dtype == wd and got.shape == (300, 64)
    if wd == F32:
        assert _mm_close(got, want, sp.float(), w)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("dtypes", MIXED_FLASH)
def test_flash_attention_kernel_mixed_dtypes_match_plain(cuda, dtypes):
    """Not all bfloat16: the float32 CUDA-core kernel on float32 copies
    (the tensor-core counter stays put), the result in ``q.dtype``; within
    1e-5 for a float32 ``q`` and one rounding (1e-2) of a half-width one,
    into a fresh tensor and into a strided ``out``."""
    q, k, v = (t.to(d) for t, d in zip(
        _flash_inputs(cuda, 2, 4, 2, 130, 64, F32), dtypes))
    before = (flash_attention_kernel.launches,
              flash_attention_kernel.tensor_core_launches)
    got = flash_attention_kernel(q, k, v, window=50)
    out = torch.zeros(2, 130, 4, 64, dtype=q.dtype,
                      device=cuda).transpose(1, 2)
    into = flash_attention_kernel(q, k, v, window=50, out=out)
    torch.cuda.synchronize()
    assert into is out
    assert (flash_attention_kernel.launches,
            flash_attention_kernel.tensor_core_launches) == (before[0] + 2,
                                                             before[1])
    want = flash_attention_plain(q, k, v, window=50)
    assert got.dtype == dtypes[0] and got.shape == q.shape
    tol = 1e-5 if dtypes[0] == F32 else 1e-2
    for res in (got, out):
        torch.testing.assert_close(res.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b",
                                  "minicpm3-4b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_smoke_generate_on_the_card_goes_through_the_kernel(cuda, arch,
                                                            monkeypatch):
    """A smoke-size model served on the card: one flash launch per layer of
    the prefill; its prefill logits within atol 1e-4 of the plain attention
    route's and of the same model on the CPU (float32); decode equals
    ``forward`` within 2e-4 (``tests/test_models.py``'s bound)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers, lm
    from repro_torch.models.specs import materialize, tree_map
    cfg = get_smoke_config(arch)
    cpu = materialize(lm.lm_specs(cfg), torch.Generator().manual_seed(0),
                      device="cpu")
    params = tree_map(lambda t: t.to(cuda), cpu)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    before = flash_attention_kernel.launches
    toks = generate(params, cfg, prompts, 4, device=cuda)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + cfg.n_layers
    assert toks.shape == (2, 44) and toks.device.type == "cuda"

    def prefill(p, dev):
        cache = materialize(lm.cache_specs(cfg, 2, 44), device=dev)
        return lm.prefill(p, cfg, torch.as_tensor(prompts, device=dev),
                          cache)[0]

    kernel = prefill(params, cuda)
    torch.testing.assert_close(kernel.cpu(), prefill(cpu, "cpu"), rtol=1e-4,
                               atol=1e-4)
    monkeypatch.setattr(layers, "_flash_forward", flash_attention_plain)
    torch.testing.assert_close(kernel, prefill(params, cuda), rtol=1e-4,
                               atol=1e-4)
    monkeypatch.undo()
    full, _ = lm.forward(params, cfg, toks)
    cache = materialize(lm.cache_specs(cfg, 2, 44), device=cuda)
    pre, cache = lm.prefill(params, cfg, toks[:, :41], cache)
    errs = [(pre[:, 0] - full[:, 40]).abs().max().item()]
    for i in range(41, 44):
        lg, cache = lm.decode_step(params, cfg, cache, toks[:, i:i + 1], i)
        errs.append((lg[:, 0] - full[:, i]).abs().max().item())
    assert max(errs) < 2e-4, errs


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """The recurrent families served on the card at their smoke configs
    (float32): one flash launch per shared-block application of the prefill
    (zamba2; none for xlstm); prefill logits within atol 1e-4 of the same
    model on the CPU; prefill over 32 positions and 4 decode steps (the
    Mamba2 / mLSTM / sLSTM states and the shared K/V written in place)
    against ``forward`` within 2e-4, and each decode step within 1e-4 of
    the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, tree_map
    cfg = get_smoke_config(arch)
    cpu = materialize(lm.lm_specs(cfg), torch.Generator().manual_seed(0),
                      device="cpu")
    params = tree_map(lambda t: t.to(cuda), cpu)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    before = flash_attention_kernel.launches
    toks = generate(params, cfg, prompts, 4, device=cuda)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + _attention_layers(cfg)
    assert toks.shape == (2, 36) and toks.device.type == "cuda"
    full, _ = lm.forward(params, cfg, toks[:, :32])
    seen = {}
    for dev, p in ((cuda, params), (torch.device("cpu"), cpu)):
        cache = materialize(lm.cache_specs(cfg, 2, 36), device=dev)
        t = toks.to(dev)
        out = [lm.prefill(p, cfg, t[:, :32], cache)[0][:, 0]]
        for i in range(32, 36):
            out.append(lm.decode_step(p, cfg, cache, t[:, i:i + 1], i)[0]
                       [:, 0])
        seen[dev.type] = [o.cpu() for o in out]
    torch.testing.assert_close(seen["cuda"][0], full[:, 31].cpu(),
                               rtol=0, atol=2e-4)
    for a, b in zip(seen["cuda"], seen["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    full36, _ = lm.forward(params, cfg, torch.cat(
        [toks, toks[:, :28]], dim=1))       # 64 positions: two SSD chunks
    for i, lg in enumerate(seen["cuda"][1:]):
        torch.testing.assert_close(lg, full36[:, 32 + i].cpu(), rtol=0,
                                   atol=2e-4)


def test_recurrent_layers_repeat_under_deterministic_algorithms(cuda):
    """A Mamba2, an mLSTM and an sLSTM layer at their full widths (zamba2's
    bf16 Mamba2 over 2 x 256 tokens, xlstm-125m's float32 cells over 2 x
    128), forward and backward under ``torch.use_deterministic_algorithms``
    in a process of its own (cuBLAS reads its workspace setting once per
    process): no op refuses, and two runs give bit-identical outputs and
    gradients."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models import mamba2, xlstm
        from repro_torch.models.specs import materialize, tree_leaves
        torch.use_deterministic_algorithms(True)
        z, x = get_config("zamba2-2.7b"), get_config("xlstm-125m")
        cases = [
            (mamba2.mamba_specs(z.d_model, z.ssm),
             lambda p, h: mamba2.mamba_block(p, h, z, z.ssm)[0],
             (2, 256, z.d_model), torch.bfloat16),
            (xlstm.mlstm_specs(x.d_model, x.xlstm, torch.float32),
             lambda p, h: xlstm.mlstm_block(p, h, x.xlstm)[0],
             (2, 128, x.d_model), torch.float32),
            (xlstm.slstm_specs(x.d_model, x.xlstm, torch.float32),
             lambda p, h: xlstm.slstm_block(p, h, x.xlstm)[0],
             (2, 128, x.d_model), torch.float32)]
        for i, (specs, fn, shape, dtype) in enumerate(cases):
            params = materialize(specs, torch.Generator(device="cuda")
                                 .manual_seed(i), device="cuda")
            leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
            h = torch.randn(shape, generator=torch.Generator(device="cuda")
                            .manual_seed(9), device="cuda").to(dtype)
            runs = []
            for _ in range(2):
                out = fn(params, h)
                grads = torch.autograd.grad(out.float().square().mean(),
                                            leaves)
                runs.append([out] + list(grads))
            torch.cuda.synchronize()
            for a, b in zip(*runs):
                assert torch.equal(a, b), i
                assert bool(torch.isfinite(a.float()).all()), i
    """)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.parametrize("dn,dr,dv", [(64, 32, 64), (128, 64, 128)])
def test_flash_attention_kernel_on_mla_padded_values(cuda, dn, dr, dv):
    """MLA's prefill (minicpm3-4b, deepseek-v3-671b head dims): q and k are
    ``cat(nope, rope)`` with the rope key shared by every head, v is padded
    with zeros from ``dv`` to ``dn + dr``, all as BSHD views. The padded
    columns come out exactly 0, the rest within 1e-2 of the plain version
    (bf16)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, s, h = 2, 300, 8
    q = torch.randn(b, s, h, dn + dr, generator=gen, device=cuda) * 0.5
    k_nope = torch.randn(b, s, h, dn, generator=gen, device=cuda) * 0.5
    k_rope = torch.randn(b, s, 1, dr, generator=gen, device=cuda) * 0.5
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    v = torch.nn.functional.pad(
        torch.randn(b, s, h, dv, generator=gen, device=cuda), (0, dn + dr - dv))
    q, k, v = (t.bfloat16().transpose(1, 2) for t in (q, k, v))
    got = flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v)
    assert torch.count_nonzero(got[..., dv:]) == 0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


def test_moe_combine_repeats_bit_for_bit_on_the_card(cuda):
    """One qwen3-moe-30b-a3b MoE layer at full width (128 experts, top-8,
    d_ff 768, bf16 weights, float32 router) over 4 x 256 tokens at the
    published capacity factor 1.25: two calls give bit-identical outputs
    and aux, and so do two more under ``torch.use_deterministic_algorithms``
    (each in a process of its own: cuBLAS reads its workspace setting once
    per process); the combine takes no atomics."""
    code = textwrap.dedent("""
        import sys
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models.moe import moe_apply, moe_specs
        from repro_torch.models.specs import materialize
        cfg = get_config("qwen3-moe-30b-a3b")
        params = materialize(moe_specs(cfg.d_model, cfg.moe),
                             torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(4, 256, cfg.d_model, generator=gen,
                        device="cuda").bfloat16()
        if sys.argv[1] == "deterministic":
            torch.use_deterministic_algorithms(True)
        outs = [moe_apply(params, x, cfg.moe) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0][0], outs[1][0]), "outputs differ"
        assert torch.equal(outs[0][1], outs[1][1]), "aux differs"
        assert bool(torch.isfinite(outs[0][0].float()).all())
    """)
    for mode in ("default", "deterministic"):
        env = dict(os.environ)
        if mode == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        proc = subprocess.run([sys.executable, "-c", code, mode],
                              capture_output=True, text=True, timeout=600,
                              env=env)
        assert proc.returncode == 0, (mode, proc.stderr[-3000:])


# ---- RoPE -------------------------------------------------------------------

# (name, x's base shape, the slice of its last dim RoPE takes, positions:
# "arange", ("at", p): [p], or ("rows", hi): random int32 [B, S] below hi,
# theta): the GQA attention's q and k (internlm2, full size too), MLA's
# strided q_rope and its [B, S, 1, Dr] k_rope, seamless, a decode step, a
# pair count off the 8-pair chunks and a view off 16 bytes (the pair-a-thread
# path), and angles past the fast range reduction
ROPE_CASES = [
    ("internlm2_q", (2, 300, 16, 128), None, "arange", 1e6),
    ("internlm2_k", (2, 300, 8, 128), None, "arange", 1e6),
    ("internlm2_full_q", (32, 4096, 16, 128), None, "arange", 1e6),
    ("minicpm3_q_rope", (2, 300, 40, 96), (64, 96), "arange", 1e4),
    ("minicpm3_k_rope", (2, 300, 1, 32), None, "arange", 1e4),
    ("deepseek_q_rope", (2, 300, 16, 192), (128, 192), "arange", 1e4),
    ("deepseek_k_rope", (2, 300, 1, 64), None, "arange", 1e4),
    ("seamless", (4, 300, 16, 64), None, "arange", 1e4),
    ("decode", (4, 1, 16, 128), None, ("at", 2047), 1e6),
    ("rows", (3, 300, 4, 64), None, ("rows", 1_000_000), 1e4),
    ("half_off_chunks", (2, 300, 4, 20), None, "arange", 1e4),
    ("view_off_16_bytes", (2, 300, 4, 66), (2, 66), "arange", 1e4),
]


def _rope_inputs(case, dtype, dev, seed=0):
    _, shape, cut, pos, theta = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
    if cut is not None:
        x = x[..., cut[0]:cut[1]]
    b, s = shape[:2]
    if pos == "arange":
        positions = torch.arange(s, device=dev)
    elif pos[0] == "at":
        positions = torch.full((1,), pos[1], dtype=torch.int64, device=dev)
    else:
        positions = torch.randint(0, pos[1], (b, s), generator=gen,
                                  device=dev, dtype=torch.int32)
    d = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
    d[:, :1] = 0.0                     # zero cotangents: the sign of zero
    return x, positions, theta, d


def _rope_bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("case", ROPE_CASES, ids=[c[0] for c in ROPE_CASES])
def test_rope_kernel_is_bit_identical_to_the_ops(cuda, case, dtype):
    """Forward: the kernel against ``rope_plain`` (the torch ops
    ``apply_rope`` ran before it) on the card. Inverse: against autograd's
    gradient through those ops and against the plain inverse. Through
    ``apply_rope`` (the autograd Function) the same bits both ways. One
    launch a call, counted by direction."""
    from repro_torch.models import layers
    x, positions, theta, d = _rope_inputs(case, dtype, cuda)
    xg = x.detach().requires_grad_()
    want = rope_plain(xg, positions, theta)
    (grad,) = torch.autograd.grad(want, xg, d)
    before = (rope_kernel.launches, rope_kernel.backward_launches)
    got = rope_kernel(x, positions, theta)
    back = rope_kernel(d, positions, theta, inverse=True)
    xf = x.detach().requires_grad_()
    fwd = layers.apply_rope(xf, positions, theta)
    (fgrad,) = torch.autograd.grad(fwd, xf, d)
    torch.cuda.synchronize()
    assert (rope_kernel.launches, rope_kernel.backward_launches) == (
        before[0] + 2, before[1] + 2)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(_rope_bits(got), _rope_bits(want))
    assert torch.equal(_rope_bits(fwd), _rope_bits(want))
    assert torch.equal(_rope_bits(back), _rope_bits(grad))
    assert torch.equal(_rope_bits(fgrad), _rope_bits(grad))
    assert torch.equal(_rope_bits(back), _rope_bits(
        rope_plain(d, positions, theta, inverse=True)))


@pytest.mark.parametrize("what", ["odd head dim", "positions of another "
                                  "length", "strided head dim",
                                  "positions on the host"])
def test_rope_kernel_refuses_what_it_cannot_take(cuda, what):
    x = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16, device=cuda)
    positions = torch.arange(8, device=cuda)
    if what == "odd head dim":
        x = torch.zeros(2, 8, 4, 63, dtype=torch.bfloat16, device=cuda)
    elif what == "positions of another length":
        positions = torch.arange(9, device=cuda)
    elif what == "strided head dim":
        x = torch.zeros(2, 8, 4, 128, dtype=torch.bfloat16,
                        device=cuda)[..., ::2]
    else:
        positions = positions.cpu()
    before = (rope_kernel.launches, rope_kernel.backward_launches)
    with pytest.raises(ValueError):
        rope_kernel(x, positions)
    assert (rope_kernel.launches, rope_kernel.backward_launches) == before


def test_rope_kernel_in_a_smoke_training_step(cuda):
    """internlm2's smoke model, one training step under ``remat="full"``:
    4 x L forward launches (q and k, forward and recomputed) and 2 x L
    inverse ones; profiled, ``bench/harness/spans.py`` puts every RoPE
    kernel in ``model.rope``, 2 x L in each of the forward, recompute and
    backward passes."""
    import dataclasses
    from collections import Counter
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, tree_map
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import (TrainConfig, init_optimizer,
                                        make_train_step)
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench.harness import spans

    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                              remat="full", logit_chunk=8)
    params = tree_map(lambda t: t.to(cuda), materialize(
        lm.lm_specs(cfg), torch.Generator().manual_seed(0), device="cpu"))
    tcfg = TrainConfig(adam=AdamWConfig(lr=1e-3, grad_clip=1.0))
    step = make_train_step(
        lambda p, b: lm.lm_loss(p, cfg, b["tokens"], b["labels"]), tcfg)
    tok = torch.randint(0, cfg.vocab, (2, 33),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = init_optimizer(params, tcfg)
    n = cfg.n_layers
    before = (rope_kernel.launches, rope_kernel.backward_launches)
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    assert (rope_kernel.launches, rope_kernel.backward_launches) == (
        before[0] + 4 * n, before[1] + 2 * n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    owned = [o for o in spans.attribute(spans.rows(prof))
             if "rope_kernel" in o.op.name]
    assert {o.owner for o in owned} == {"model.rope"}
    assert Counter(o.pass_ for o in owned) == {
        "forward": 2 * n, "recompute": 2 * n, "backward": 2 * n}
