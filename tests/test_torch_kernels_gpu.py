"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips, with a reason, on a host without
CUDA; the ``cuda`` fixture decides at run time, never at import. On the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Integer weights whose partial sums stay below 2^24 must match exactly.
``link_traffic``'s float weights agree within rtol=1e-5, atol=1e-3
(shared-memory atomics add in a run-dependent order); ``delta_cost``'s float
volumes within 1e-5 of each chain's sum of absolute terms (its warp
reduction adds in another order than the plain row sum).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import NoC  # noqa: E402
from repro_torch.kernels.delta_cost import (delta_cost,  # noqa: E402
                                            delta_cost_plain)
from repro_torch.kernels.noc_segsum import (link_traffic,  # noqa: E402
                                            link_traffic_plain)

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
    """The device SA through the kernel (one launch per step) and through
    its plain version: the same placement on an integer-volume graph, whose
    partial sums stay below 2^24 so both add exactly."""
    from repro_torch.core import graph, topology
    from repro_torch.core.placement import device_search
    g = graph.random_dag(24, p=0.3, seed=2)
    g = graph.LogicalGraph(np.round(g.adj), g.compute, g.memory)
    noc = topology.parse_topology("mesh:4x8")
    kw = dict(iters=150, seed=3, restarts=3, device=cuda)
    before = delta_cost.launches
    plain = device_search.simulated_annealing_device(g, noc, use_pallas=False,
                                                     **kw)
    assert delta_cost.launches == before
    kernel = device_search.simulated_annealing_device(g, noc, **kw)
    assert delta_cost.launches == before + 150
    assert np.array_equal(kernel, plain)
