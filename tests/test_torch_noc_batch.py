"""Port parity: the batched NoC evaluator, the fused objective scorers and the
link-traffic kernel's plain version, against the JAX package.

Grades: the numpy backend and the torch backend in float64 are exact on
integer-volume graphs; the float32 torch/cuda paths stay within the bounds
the reference uses for its own pallas backend (rtol=1e-5, atol=1e-3). The
cuda backend runs here on CPU tensors, i.e. through the kernel's plain
version.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as r_graph  # noqa: E402
from repro.core import noc_batch as r_nb  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.deploy import objective as r_objective  # noqa: E402
from repro.kernels.noc_segsum import link_traffic_pallas  # noqa: E402

from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core import noc_batch as p_nb  # noqa: E402
from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.deploy import objective as p_objective  # noqa: E402
from repro_torch.kernels.noc_segsum import link_traffic  # noqa: E402

SPECS = ["mesh:3x5", "torus:4x4", "torus:3x5", "hier:2x2:2x2"]
FIELDS = ("comm_cost", "mean_hops", "max_hops", "max_link", "latency",
          "throughput", "core_traffic", "link_traffic")


def _case(spec, seed=7, B=6):
    """(ref topology, port topology, ref graph, port graph, placements) on
    an integer-volume random DAG."""
    ref = r_topology.parse_topology(spec, link_bw=1.6e9, core_flops=2e9)
    port = p_topology.parse_topology(spec, link_bw=1.6e9, core_flops=2e9)
    n = ref.n_cores - 2
    g = r_graph.random_dag(n, seed=seed)
    rg = r_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    pg = p_graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    rng = np.random.default_rng(seed)
    P = np.stack([rng.permutation(ref.n_cores)[:n] for _ in range(B)])
    return ref, port, rg, pg, P


@pytest.mark.parametrize("spec", SPECS)
def test_numpy_backend_exact(spec):
    ref, port, rg, pg, P = _case(spec)
    m_ref = r_nb.evaluate_batch(ref, rg, P, backend="numpy")
    m_port = p_nb.evaluate_batch(port, pg, P, backend="numpy")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(m_port, f), getattr(m_ref, f))
    np.testing.assert_array_equal(
        p_nb.comm_cost_batch(port, pg, P, backend="batch"),
        r_nb.comm_cost_batch(ref, rg, P, backend="batch"))
    if spec != "hier:2x2:2x2":
        np.testing.assert_array_equal(
            p_nb.directional_cdv_batch(port, pg, P, backend="numpy"),
            r_nb.directional_cdv_batch(ref, rg, P, backend="numpy"))


@pytest.mark.parametrize("spec", SPECS)
def test_torch_float64_exact_on_integer_volumes(spec):
    ref, port, rg, pg, P = _case(spec)
    m_ref = r_nb.evaluate_batch(ref, rg, P, backend="numpy")
    m_port = p_nb.evaluate_batch(port, pg, P, backend="torch", device="cpu",
                                 dtype=torch.float64)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(m_port, f), getattr(m_ref, f))
    np.testing.assert_array_equal(
        p_nb.comm_cost_batch(port, pg, P, backend="torch", device="cpu",
                             dtype=torch.float64),
        m_ref.comm_cost)


@pytest.mark.parametrize("backend", ["torch", "jax", "cuda", "pallas"])
@pytest.mark.parametrize("spec", SPECS)
def test_float32_backends_within_tolerance(spec, backend):
    ref, port, rg, pg, P = _case(spec)
    m_ref = r_nb.evaluate_batch(ref, rg, P, backend="numpy")
    m = p_nb.evaluate_batch(port, pg, P, backend=backend, device="cpu")
    for f in ("comm_cost", "max_link", "latency", "core_traffic",
              "link_traffic"):
        np.testing.assert_allclose(getattr(m, f), getattr(m_ref, f),
                                   rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(m.max_hops, m_ref.max_hops)
    np.testing.assert_allclose(
        p_nb.make_scorer(port, pg, backend, device="cpu")(P), m_ref.comm_cost,
        rtol=1e-5)


@pytest.mark.parametrize("B,K,n_links", [(3, 500, 256), (1, 7, 16),
                                         (2, 130, 20), (4, 1024, 100)])
def test_segsum_plain_matches_pallas_interpret(B, K, n_links):
    rng = np.random.default_rng(B * 1000 + K)
    ids = rng.integers(0, n_links + 1, size=(B, K)).astype(np.int32)
    w = rng.random((B, K)).astype(np.float32)
    ref = np.asarray(link_traffic_pallas(jnp.asarray(ids), jnp.asarray(w),
                                         n_links, interpret=True))
    got = link_traffic(torch.as_tensor(ids), torch.as_tensor(w), n_links)
    assert got.dtype == torch.float32 and got.shape == (B, n_links)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_segsum_plain_all_padding():
    ref = np.asarray(link_traffic_pallas(jnp.full((2, 64), 16, jnp.int32),
                                         jnp.ones((2, 64), jnp.float32), 16,
                                         interpret=True))
    got = link_traffic(torch.full((2, 64), 16, dtype=torch.int32),
                       torch.ones(2, 64), 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), 0.0)


OBJECTIVE_SPECS = ["latency", "max_link", "energy", "interchip", "mean_hops",
                   {"comm_cost": 1.0, "energy": 2e9},
                   {"max_link": 2.0, "interchip": 0.5}]


@pytest.mark.parametrize("spec", ["torus:4x4", "hier:2x2:2x2"])
def test_fused_scorer_matches_reference_pallas(spec):
    ref, port, rg, pg, P = _case(spec)
    for obj in OBJECTIVE_SPECS:
        want = r_objective.objective_scorer(ref, rg, obj, backend="pallas")(P)
        for backend in ("cuda", "torch"):
            got = p_objective.objective_scorer(port, pg, obj, backend=backend,
                                               device="cpu")(P)
            np.testing.assert_allclose(got, want, rtol=2e-5)
        unfused = p_objective.objective_scorer(port, pg, obj, backend="cuda",
                                               fused=False, device="cpu")(P)
        np.testing.assert_allclose(unfused, want, rtol=2e-5)
        exact = p_objective.objective_scorer(port, pg, obj, backend="batch")(P)
        np.testing.assert_array_equal(
            exact, r_objective.objective_scorer(ref, rg, obj, "batch")(P))


def test_backend_errors():
    port = p_topology.parse_topology("mesh:3x3")
    g = p_graph.random_dag(6, seed=0)
    b = p_nb.batched_noc(port)
    with pytest.raises(ValueError, match="fused scorer"):
        b.make_fused_scorer(g, (("hops_cubed", 1.0),), device="cpu")
    with pytest.raises(ValueError, match="torch/cuda"):
        b.make_fused_scorer(g, (("max_link", 1.0),), backend="batch")
    with pytest.raises(ValueError, match="unknown backend"):
        p_nb.make_scorer(port, g, "tpu")
    with pytest.raises(ValueError, match="reference"):
        b.evaluate(g, np.arange(6), backend="reference")


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = p_topology.parse_topology("mesh:3x3")
    g = p_graph.random_dag(6, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_nb.evaluate_batch(port, g, np.arange(6), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_nb.make_scorer(port, g, "torch", objective="latency")


def test_device_tables_cached_per_device_and_dtype():
    b = p_nb.batched_noc(p_topology.parse_topology("hier:2x2:2x2"))
    t32 = b.device_tables("cpu", torch.float32)
    assert b.device_tables("cpu", torch.float32) is t32
    t64 = b.device_tables("cpu", torch.float64)
    assert t64 is not t32 and t64.inv_bw.dtype == torch.float64
    assert t32.routes.dtype == torch.int32
    np.testing.assert_array_equal(t32.hops.numpy(),
                                  b.tables.hops.reshape(-1))
    assert jax.default_backend() == "cpu"
