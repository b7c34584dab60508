"""Port parity, exact grade: the numpy-level core of ``repro_torch`` against
the JAX package (topology tables, graphs, profiles, partitions, schedules,
constructors, the host discretizer)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402,F401  (reference side; stays on the CPU)

from repro.core import graph as r_graph  # noqa: E402
from repro.core import pipeline as r_pipeline  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core.noc import NoC as RNoC  # noqa: E402
from repro.core.noc_batch import build_tables as r_build_tables  # noqa: E402
from repro.core.partition import partition_model as r_partition  # noqa: E402
from repro.core.placement import baselines as r_baselines  # noqa: E402
from repro.core.placement import discretize_batch as r_disc  # noqa: E402
from repro.snn import models as r_models  # noqa: E402
from repro.snn.profile import profile_model as r_profile  # noqa: E402

from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core import pipeline as p_pipeline  # noqa: E402
from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.core.noc import NoC as PNoC  # noqa: E402
from repro_torch.core.noc_batch import build_tables as p_build_tables  # noqa: E402
from repro_torch.core.partition import partition_model as p_partition  # noqa: E402
from repro_torch.core.placement import baselines as p_baselines  # noqa: E402
from repro_torch.core.placement import discretize_batch as p_disc  # noqa: E402
from repro_torch.snn import models as p_models  # noqa: E402
from repro_torch.snn.profile import profile_model as p_profile  # noqa: E402

# (reference, port) constructor pairs of the topologies the tables cover
TOPOLOGIES = {
    "mesh4x4": (lambda: RNoC(4, 4), lambda: PNoC(4, 4)),
    "torus4x4": (lambda: RNoC(4, 4, torus=True),
                 lambda: PNoC(4, 4, torus=True)),
    "torus3x5": (lambda: RNoC(3, 5, torus=True),
                 lambda: PNoC(3, 5, torus=True)),
    "hier2x2:2x2": (lambda: r_topology.HierarchicalMesh(2, 2, 2, 2),
                    lambda: p_topology.HierarchicalMesh(2, 2, 2, 2)),
}


def _same(a, b):
    """Exact equality of plain values, arrays and (nested) dataclasses."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_routing_tables_exact(name):
    ref, port = (f() for f in TOPOLOGIES[name])
    _same(r_build_tables(ref), p_build_tables(port))
    assert ref.cache_key() == port.cache_key()
    assert ref.describe() == port.describe()


@pytest.mark.parametrize("spec", ["mesh:4x8", "torus:6x6,bw=2e9",
                                  "hier:2x2:3x3,ibw=1e8"])
def test_parse_topology_exact(spec):
    ref = r_topology.parse_topology(spec)
    port = p_topology.parse_topology(spec)
    assert ref.cache_key() == port.cache_key()
    _same(r_build_tables(ref), p_build_tables(port))


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_reference_evaluate_exact(name):
    ref, port = (f() for f in TOPOLOGIES[name])
    g = r_graph.random_dag(ref.n_cores - 1, seed=4)
    pg = p_graph.LogicalGraph(g.adj, g.compute, g.memory)
    p = np.random.default_rng(0).permutation(ref.n_cores)[:g.n]
    _same(ref.evaluate(g, p), port.evaluate(pg, p))


@pytest.mark.parametrize("make", [
    lambda m: m.random_dag(12, seed=3),
    lambda m: m.layered_dag(4, 5, seed=1),
    lambda m: m.moe_dag(2, 6, top_k=2, seed=2),
    lambda m: m.chain_graph([3.0, 1.0, 4.0, 1.0]),
])
def test_graph_generators_and_features_exact(make):
    ref, port = make(r_graph), make(p_graph)
    for attr in ("adj", "compute", "memory"):
        np.testing.assert_array_equal(getattr(ref, attr), getattr(port, attr))
    _same(ref.edge_arrays(), port.edge_arrays())
    np.testing.assert_array_equal(ref.laplacian(), port.laplacian())
    np.testing.assert_array_equal(ref.node_features(), port.node_features())


@pytest.mark.parametrize("model", ["spike_vgg16", "spike_resnet18",
                                   "spike_resnet50"])
def test_profile_model_exact(model):
    ref = r_profile(getattr(r_models, model)(), batch=8, training=True)
    port = p_profile(getattr(p_models, model)(), batch=8, training=True)
    _same(ref, port)


@pytest.mark.parametrize("strategy,cores", [("balanced", 16), ("balanced", 64),
                                            ("chip", 16)])
def test_partition_exact(strategy, cores):
    ref_prof = r_profile(r_models.spike_vgg16(), batch=8, training=True)
    port_prof = p_profile(p_models.spike_vgg16(), batch=8, training=True)
    kw_r = kw_p = {}
    if strategy == "chip":
        kw_r = {"topology": r_topology.HierarchicalMesh(2, 2, 2, 2)}
        kw_p = {"topology": p_topology.HierarchicalMesh(2, 2, 2, 2)}
    ref = r_partition(ref_prof, cores, strategy, **kw_r)
    port = p_partition(port_prof, cores, strategy, **kw_p)
    _same(ref, port)
    rg, pg = ref.to_graph(), port.to_graph()
    for attr in ("adj", "compute", "memory", "chip_of"):
        _same(getattr(rg, attr), getattr(pg, attr))


@pytest.mark.parametrize("schedule,training", [("fpdeep", True),
                                               ("fpdeep", False),
                                               ("layerwise", True)])
def test_schedule_exact(schedule, training):
    times = list(np.random.default_rng(1).uniform(0.5, 2.0, 7))
    ref = getattr(r_pipeline, schedule)(times, 8, 2.0, training)
    port = getattr(p_pipeline, schedule)(times, 8, 2.0, training)
    _same(ref, port)
    assert ref.mean_utilization() == port.mean_utilization()


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_constructors_exact(name):
    ref, port = (f() for f in TOPOLOGIES[name])
    n = ref.n_cores - 3
    _same(r_baselines.zigzag(n, ref), p_baselines.zigzag(n, port))
    _same(r_baselines.sigmate(n, ref), p_baselines.sigmate(n, port))


def test_chip_init_exact():
    ref_topo = r_topology.HierarchicalMesh(2, 2, 2, 2)
    port_topo = p_topology.HierarchicalMesh(2, 2, 2, 2)
    ref_prof = r_profile(r_models.spike_vgg16(), batch=8, training=True)
    port_prof = p_profile(p_models.spike_vgg16(), batch=8, training=True)
    rg = r_partition(ref_prof, 16, "chip", topology=ref_topo).to_graph()
    pg = p_partition(port_prof, 16, "chip", topology=port_topo).to_graph()
    _same(r_baselines.chip_init(rg, ref_topo), p_baselines.chip_init(pg,
                                                                      port_topo))


@pytest.mark.parametrize("rows,cols,n,prio", [(4, 4, 12, False),
                                              (3, 5, 15, True),
                                              (8, 8, 64, False)])
def test_actions_to_placement_batch_exact(rows, cols, n, prio):
    rng = np.random.default_rng(rows * cols + n)
    acts = rng.normal(0.0, 0.6, size=(16, n, 2))
    priority = rng.permutation(n) if prio else None
    _same(r_disc.actions_to_placement_batch(acts, rows, cols, 1.0, priority),
          p_disc.actions_to_placement_batch(acts, rows, cols, 1.0, priority))


def test_device_resolver_not_ported():
    """The device resolver, under the reference's name, against the
    reference's jitted resolver on the same cells."""
    rng = np.random.default_rng(11)
    cells = r_disc.continuous_to_grid_batch(rng.normal(size=(8, 16, 2)), 4, 4)
    got = p_disc.make_jax_resolver(4, 4, device="cpu")(cells)
    assert got.dtype == torch.int64
    _same(np.asarray(r_disc.make_jax_resolver(4, 4)(cells)), got.numpy())


@pytest.mark.parametrize("rows,cols,n,order", [
    (4, 4, 16, None), (3, 5, 12, "full"), (3, 5, 12, "partial"),
    (8, 8, 64, "full"), (2, 3, 6, "collide")])
def test_device_resolver_exact(rows, cols, n, order):
    """Exact against the numpy resolver and the reference's jitted one, as
    tests/test_discretize_batch.py::test_jax_resolver_matches_numpy holds
    it: full and partial priority orders (unvisited nodes stay -1), and every
    node starting on one cell."""
    rng = np.random.default_rng(rows * cols + n)
    cells = r_disc.continuous_to_grid_batch(rng.normal(size=(8, n, 2)), rows,
                                            cols)
    prio = rng.permutation(n)
    if order == "collide":
        cells = np.zeros_like(cells)
    p = {"full": prio, "partial": prio[: n // 2]}.get(order)
    got = p_disc.make_torch_resolver(rows, cols, p, device="cpu")(cells)
    want = r_disc.resolve_collisions_batch(cells, rows, cols, p)
    _same(want, got.numpy())
    _same(np.asarray(r_disc.make_jax_resolver(rows, cols, p)(cells)),
          got.numpy())


def test_device_resolver_rejects_duplicates_and_overflow():
    for make in (r_disc.make_jax_resolver, p_disc.make_torch_resolver):
        kw = {} if make is r_disc.make_jax_resolver else {"device": "cpu"}
        with pytest.raises(ValueError, match="duplicate"):
            make(4, 4, np.array([0, 1, 1]), **kw)
        with pytest.raises(ValueError, match="do not fit"):
            make(2, 2, **kw)(np.zeros((3, 5), dtype=np.int64))
