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
float32 in the same order and round once). ``spike_matmul`` agrees within
rtol=atol=1e-4 and within 1e-4 + 1e-4 x (|spikes| @ |w|) in float32
(another summation order than cuBLAS) and rtol=atol=1e-2 in bfloat16 (one
rounding of the output), and its
count of skipped tiles is exact. A full-width Spike-VGG16 training step
through the LIF kernel is bit-identical to the same step through the plain
version, with deterministic cuDNN. The flash-attention kernel agrees with
its plain version within rtol=atol=1e-5 in float32 and 1e-2 in bfloat16, and
a smoke-size model served on the card goes through it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import NoC  # noqa: E402
from repro_torch.kernels.delta_cost import (delta_cost,  # noqa: E402
                                            delta_cost_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.lif import (lif_step_kernel,  # noqa: E402
                                     lif_step_plain)
from repro_torch.kernels.noc_segsum import (link_traffic,  # noqa: E402
                                            link_traffic_plain)
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
        lif_step_kernel(u, s.bfloat16(), c)
    with pytest.raises(ValueError):
        lif_step_kernel(u, s[:, :4], c)
    with pytest.raises(ValueError):
        lif_step_kernel(u.t(), s.t(), c.t())
    with pytest.raises(ValueError):
        lif_step_kernel(u, s.cpu(), c)
    with pytest.raises(ValueError):
        lif_step_kernel(u, s, c, reset="none")
    assert lif_step_kernel.launches == before


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("surrogate", ["rect", "sigmoid", "atan"])
def test_lif_function_gradients_through_the_kernel(cuda, reset, surrogate,
                                                   monkeypatch):
    """``snn.neurons.lif_step`` over three timesteps through the kernel, and
    through the plain version on the card: equal states and equal
    gradients (the backward is the same torch code; the forwards are
    bit-identical)."""
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

    before = lif_step_kernel.launches
    kernel = run()
    assert lif_step_kernel.launches == before + 3
    monkeypatch.setattr(neurons, "_lif_forward", lif_step_plain)
    plain = run()
    assert lif_step_kernel.launches == before + 3
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.15, 1.0])
def test_spike_matmul_kernel_matches_plain(cuda, m, k, n, density):
    from repro_torch.kernels.spike_matmul import zero_tiles
    rng = np.random.default_rng(m + k + n)
    sp = torch.as_tensor((rng.random((m, k)) < density).astype(np.float32),
                         device=cuda)
    w = torch.as_tensor((rng.standard_normal((k, n)) / np.sqrt(3))
                        .astype(np.float32), device=cuda)
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
        spike_matmul_kernel(sp, w.bfloat16())
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
    LIF kernel and through its plain version on the card, deterministic
    cuDNN: the same loss and the same gradient, bit for bit."""
    from repro_torch.snn import bptt, models, neurons
    cfg = models.spike_vgg16()
    net = models.init_model(cfg, torch.Generator().manual_seed(0),
                            device=cuda)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((8, 32, 32, 3), np.float32), device=cuda)
    y = torch.as_tensor(rng.integers(0, 10, 8), device=cuda)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    before = lif_step_kernel.launches
    kernel = bptt.loss_and_grads(net, cfg, x, y)
    torch.cuda.synchronize()
    assert lif_step_kernel.launches == before + 13 * cfg.T
    monkeypatch.setattr(neurons, "_lif_forward", lif_step_plain)
    plain = bptt.loss_and_grads(net, cfg, x, y)
    assert lif_step_kernel.launches == before + 13 * cfg.T
    for a, b in zip(kernel[:3], plain[:3]):
        assert torch.equal(a, b)
    for (name, _), a, b in zip(net.named_parameters(), kernel[3], plain[3]):
        assert torch.equal(a, b), name


def test_ppo_with_a_cfg_scores_on_the_card_by_default(cuda):
    """``optimize_placement(method="ppo", cfg=PPOConfig(...))`` with no
    backend scores its rollouts through the link-traffic kernel."""
    from repro_torch.core.graph import random_dag
    from repro_torch.core.placement import PPOConfig, optimize_placement
    before = link_traffic.launches
    res = optimize_placement(random_dag(16, seed=0), NoC(4, 4),
                             method="ppo", objective="latency",
                             cfg=PPOConfig(batch_size=32, iterations=2))
    assert link_traffic.launches > before
    assert len(res.history) == 2


# ---- flash attention and the token server --------------------------------------

# (B, H, Hkv, S, D, window, dtype, causal): the reference sweep's shapes
# (tests/test_kernels.py) with and without a window, its bf16 case, S off
# the 64-row tile, D = 256, non-causal input, and the served shapes
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
    output)."""
    q, k, v = _flash_inputs(cuda, b, h, hkv, s, d, dtype)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_reads_and_writes_strided_views(cuda):
    """BSHD tensors go in as ``transpose(1, 2)`` views and the result lands
    in a strided ``out``, as the model's attention hands them over."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _flash_inputs(cuda, 2, 8, 2, 100, 64, torch.float32))
    assert not q.is_contiguous()
    out = torch.empty(2, 100, 8, 64, device=cuda).transpose(1, 2)
    got = flash_attention_kernel(q, k, v, window=30, out=out)
    torch.cuda.synchronize()
    assert got is out
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=30)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_kernel_rejects_bad_inputs(cuda):
    q, k, v = _flash_inputs(cuda, 1, 4, 2, 64, 32, torch.float32)
    with pytest.raises(TypeError):
        flash_attention_kernel(q.bfloat16(), k, v)
    with pytest.raises(TypeError):
        flash_attention_kernel(q.half(), k.half(), v.half())
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


def test_attention_gradient_on_the_card_raises(cuda):
    from repro_torch.models import layers
    q, k, v = _flash_inputs(cuda, 1, 8, 4, 2, 16, torch.float32)
    q = q.transpose(1, 2).contiguous().requires_grad_()
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        layers.blockwise_attention(q, k.transpose(1, 2), v.transpose(1, 2))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b"])
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
