"""The GPU-cluster adapter (``repro_torch.core.gpu_adapter``) against the
reference's TPU adapter (``repro.core.tpu_adapter``): every case of
``tests/test_tpu_adapter.py`` through the port, results equal (adjacency
matrices and ``ici_cost`` exactly, simulated annealing seed for seed);
traffic attributed by process group equal to the reference's attribution
by group size where no size is ambiguous; the rank order
``apply_assignment`` gives is the production mesh's under the same
placement; ``nvlink_cluster``'s inter-node links are the slow class.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed import _functional_collectives as funcol  # noqa: E402

from repro.core import tpu_adapter as T  # noqa: E402
from repro.core.noc import NoC as RNoC  # noqa: E402
from repro_torch.core import gpu_adapter as G  # noqa: E402
from repro_torch.core.noc import NoC as PNoC  # noqa: E402
from repro_torch.core.trace_analysis import TraceRecorder  # noqa: E402


def _world(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.mark.parametrize("shape,axis", [((2, 4), 1), ((2, 4), 0),
                                        ((2, 16, 16), 1)])
def test_axis_groups_equal_the_reference(shape, axis):
    np.testing.assert_array_equal(G._axis_groups(shape, axis),
                                  T._axis_groups(shape, axis))


@pytest.mark.parametrize("shape,ring,a2a", [
    ((4,), {0: 1000.0}, None),              # ring of 4: 2 neighbours each
    ((4,), {}, {0: 900.0}),                 # all pairs
    ((4, 8), {0: 5000.0, 1: 500.0}, {1: 77.0}),
])
def test_traffic_graphs_equal_the_reference(shape, ring, a2a):
    got = G.collective_traffic_graph(shape, ring, a2a)
    want = T.collective_traffic_graph(shape, ring, a2a)
    np.testing.assert_array_equal(got.adj, want.adj)
    np.testing.assert_array_equal(got.compute, want.compute)
    if ring and len(shape) == 1:
        assert ((got.adj > 0).sum(axis=1) == 2).all()


def test_optimized_order_equals_the_reference_seed_for_seed():
    mesh_shape = (4, 8)
    graph = G.collective_traffic_graph(mesh_shape, {0: 5000.0, 1: 500.0})
    rgraph = T.collective_traffic_graph(mesh_shape, {0: 5000.0, 1: 500.0})
    noc, rnoc = PNoC(8, 4, torus=True, link_bw=50e9), RNoC(8, 4, torus=True,
                                                            link_bw=50e9)
    base = G.ici_cost(graph, noc)
    assert base == T.ici_cost(rgraph, rnoc)
    assignment, res = G.optimize_device_order(
        graph, noc, method="simulated_annealing", budget=3000, seed=0,
        device="cpu")
    want, rres = T.optimize_device_order(
        rgraph, rnoc, method="simulated_annealing", budget=3000, seed=0)
    np.testing.assert_array_equal(assignment, want)
    assert res.comm_cost == rres.comm_cost <= base["comm_cost"]
    assert len(set(assignment.tolist())) == graph.n
    scrambled = np.random.default_rng(0).permutation(graph.n)
    got = G.ici_cost_batch(graph, noc, scrambled[None, :], device="cpu")
    ref = T.ici_cost_batch(rgraph, rnoc, scrambled[None, :],
                           backend="numpy")
    np.testing.assert_array_equal(got["comm_cost"], ref["comm_cost"])


def test_trace_collectives_end_to_end():
    """The reference's HLO case: an all-gather of bf16[512, 1024] over 16,
    an all-reduce of f32[1024] over 16, a permute of bf16[64]."""
    _world(16)
    try:
        fm = FakeTensorMode()
        with fm:
            a = torch.empty(32, 1024, dtype=torch.bfloat16)
            b = torch.empty(1024)
            c = torch.empty(64, dtype=torch.bfloat16)
        pg16, pg2 = dist.new_group(list(range(16))), dist.new_group([0, 1])
        rec = TraceRecorder(fm)
        with rec:
            funcol.all_gather_tensor(a, 0, pg16)
            funcol.all_reduce(b, "sum", pg16)
            funcol.permute_tensor(c, [1, 0], pg2)
    finally:
        dist.destroy_process_group()
    ops = G.trace_collectives(rec.trace())
    assert sorted(o.kind for o in ops) == ["all-gather", "all-reduce",
                                           "collective-permute"]
    ag = [o for o in ops if o.kind == "all-gather"][0]
    assert ag.group_size == 16
    assert ag.operand_bytes == pytest.approx(512 * 1024 * 2 / 16)
    cp = [o for o in ops if o.kind == "collective-permute"][0]
    assert cp.group_ranks == (0, 1) and cp.out_bytes == 64 * 2
    hlo = """
  %all-gather.1 = bf16[512,1024]{1,0} all-gather(%p0), replica_groups=[16,16]<=[256], dimensions={0}
  %all-reduce.2 = f32[1024]{0} all-reduce(%x), replica_groups=[16,16]<=[256]T(1,0), to_apply=%add
  %collective-permute.3 = bf16[64]{0} collective-permute(%y), source_target_pairs={{0,1},{1,2}}
"""
    want = T.collective_bytes(hlo)
    got = G.collective_bytes(rec.trace())
    assert got == want


def test_apply_assignment_is_the_production_meshs_order():
    devices = [f"d{i}" for i in range(8)]
    arr = G.apply_assignment(devices, np.arange(8)[::-1], (2, 4))
    np.testing.assert_array_equal(
        arr, T.apply_assignment(devices, np.arange(8)[::-1], (2, 4)))
    assert arr[0, 0] == "d7" and arr[1, 3] == "d0"
    from repro_torch.launch.mesh import make_production_mesh
    perm = np.random.default_rng(1).permutation(256)
    _world(256)
    try:
        mesh = make_production_mesh(placement=perm)
        np.testing.assert_array_equal(
            mesh.mesh.numpy(),
            G.apply_assignment(range(256), perm, (16, 16)).astype(int))
    finally:
        dist.destroy_process_group()


def test_traffic_from_trace_equals_traffic_from_hlo_on_2x4():
    """On (2, 4) no group size is ambiguous: an all-reduce over ``model``
    (4), an all-gather over ``data`` (2) and an all-to-all over
    ``model``."""
    from repro_torch.launch.mesh import make_test_mesh
    _world(8)
    try:
        mesh = make_test_mesh((2, 4))
        fm = FakeTensorMode()
        with fm:
            x = torch.empty(1024)
            y = torch.empty(64, 32, dtype=torch.bfloat16)
            z = torch.empty(16, 8)
        rec = TraceRecorder(fm)
        with rec:
            funcol.all_reduce(x, "sum", (mesh, 1))
            funcol.all_gather_tensor(y, 0, (mesh, 0))
            funcol.all_to_all_single(z, None, None, (mesh, 1))
        got = G.traffic_from_trace(rec.trace(), mesh)
    finally:
        dist.destroy_process_group()
    hlo = """
  %ar = f32[1024]{0} all-reduce(%x), replica_groups=[2,4]<=[8], to_apply=%add
  %ag = bf16[128,32]{1,0} all-gather(%y), replica_groups=[4,2]<=[4,2]T(1,0), dimensions={0}
  %aa = f32[16,8]{1,0} all-to-all(%z), replica_groups=[2,4]<=[8], dimensions={0}
"""
    want = T.traffic_from_hlo(hlo, (2, 4), ("data", "model"))
    assert got.n == 8 and got.adj.sum() > 0
    np.testing.assert_array_equal(got.adj, want.adj)


def test_traffic_from_trace_on_the_production_mesh():
    from repro_torch.launch.mesh import make_production_mesh
    _world(256)
    try:
        mesh = make_production_mesh()
        fm = FakeTensorMode()
        with fm:
            x = torch.empty(1048576, dtype=torch.bfloat16)
        rec = TraceRecorder(fm)
        with rec:
            funcol.all_reduce(x, "sum", (mesh, 0))     # over data
        g = G.traffic_from_trace(rec.trace(), mesh)
    finally:
        dist.destroy_process_group()
    assert g.n == 256 and g.adj.sum() > 0
    # attributed to data (the reference's size rule sends it to model)
    want = G.collective_traffic_graph((16, 16), {0: 2.0 * 15 / 16
                                                 * 1048576 * 2})
    np.testing.assert_array_equal(g.adj, want.adj)


def test_nvlink_cluster_links():
    noc = G.nvlink_cluster((4, 8))
    assert noc.n_cores == 256
    bw = noc._bw[noc._interchip]
    assert bw.size and (bw == 50e9).all()
    assert (noc._bw[~noc._interchip & (noc.link_src_array() >= 0)]
            == 450e9).any()
    cores = G.gpu_cores(noc)
    assert sorted(cores.tolist()) == list(range(256))
    np.testing.assert_array_equal(noc.chip_of_array()[cores],
                                  np.arange(256) // 8)
