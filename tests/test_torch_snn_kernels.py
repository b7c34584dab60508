"""The port's SNN kernel entry points (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops``, Pallas in interpret mode on the CPU).

On CPU tensors each wrapper runs its kernel's plain version, so these tests
hold the plain versions, the im2col layout and the SAME padding of
``spike_conv`` against the reference; the kernels themselves are held
against the plain versions on the card (``tests/test_torch_kernels_gpu.py``).
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference kernel tests' own (``tests/test_kernels.py``),
tightened to rtol 1e-6 for float32 LIF, whose plain version computes in the
reference's order.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops, ref as r_ref  # noqa: E402
from repro_torch.kernels import ops as p_ops, ref as p_ref  # noqa: E402
from repro_torch.kernels.lif import lif_step_kernel  # noqa: E402
from repro_torch.kernels import spike_matmul as p_mm  # noqa: E402
from repro_torch.kernels.spike_matmul import spike_matmul_kernel  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x, dtype):
    """One numpy float32 array as a jax and a torch array of ``dtype``
    (bfloat16 rounds to nearest even in both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.as_tensor(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---- LIF --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128,), (7, 13), (2, 9, 9, 8), (256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_lif_step_matches_reference(shape, dtype, reset):
    rng = np.random.default_rng(sum(shape))
    u = rng.standard_normal(shape).astype(np.float32)
    s = (rng.random(shape) < 0.3).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)
    (ju, tu), (js, ts), (jc, tc) = (_both(a, dtype) for a in (u, s, c))
    un, sn = p_ops.lif_step(tu, ts, tc, reset=reset)
    assert un.dtype == tu.dtype and sn.dtype == tu.dtype
    assert un.shape == shape and sn.shape == shape
    rtol, atol = (1e-6, 0.0) if dtype == "float32" else (2e-2, 1e-2)
    for ur, sr in (r_ops.lif_step(ju, js, jc, reset=reset),
                   r_ref.lif_ref(ju, js, jc, reset=reset)):
        np.testing.assert_array_equal(_np(sn), _np(sr))
        np.testing.assert_allclose(_np(un), _np(ur), rtol=rtol, atol=atol)
    # the port's oracle is the plain version itself
    ur2, sr2 = p_ref.lif_ref(tu, ts, tc, reset=reset)
    assert torch.equal(un, ur2) and torch.equal(sn, sr2)


def test_lif_step_keyword_arguments_reach_the_update():
    rng = np.random.default_rng(3)
    u, c = (rng.standard_normal((64,)).astype(np.float32) for _ in range(2))
    s = (rng.random(64) < 0.5).astype(np.float32)
    kw = dict(threshold=0.3, decay=0.9)
    for reset in ("hard", "soft"):
        un, sn = p_ops.lif_step(*map(torch.as_tensor, (u, s, c)),
                                reset=reset, **kw)
        ur, sr = r_ops.lif_step(*map(jnp.asarray, (u, s, c)), reset=reset,
                                **kw)
        np.testing.assert_array_equal(_np(sn), _np(sr))
        np.testing.assert_allclose(_np(un), _np(ur), rtol=1e-6)
    with pytest.raises(ValueError, match="reset"):
        p_ops.lif_step(*map(torch.as_tensor, (u, s, c)), reset="none")


# ---- spike matmul -----------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(32, 64, 16), (70, 200, 90),
                                   (128, 384, 256), (1, 128, 128)])
@pytest.mark.parametrize("density", [0.0, 0.15, 1.0])
def test_spike_matmul_matches_reference(m, k, n, density):
    rng = np.random.default_rng(m + k + n)
    sp = (rng.random((m, k)) < density).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    out = p_ops.spike_matmul(torch.as_tensor(sp), torch.as_tensor(w))
    ref = r_ops.spike_matmul(jnp.asarray(sp), jnp.asarray(w))
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


def test_spike_matmul_bf16_matches_reference():
    rng = np.random.default_rng(4)
    sp = (rng.random((64, 128)) < 0.2).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    (js, ts), (jw, tw) = _both(sp, "bfloat16"), _both(w, "bfloat16")
    out = p_ops.spike_matmul(ts, tw)
    assert out.dtype == torch.bfloat16
    for ref in (r_ops.spike_matmul(js, jw), r_ref.spike_matmul_ref(js, jw)):
        np.testing.assert_allclose(_np(out), _np(ref), rtol=5e-2, atol=5e-2)


def _ones_at(shape, cells):
    sp = torch.zeros(shape)
    for m, k in cells:
        sp[m, k] = 1.0
    return sp


# (M, K, n, cells that spike, skipped pairs counted by hand) with the
# kernel's 64 x 64 spike tiles and 64-wide output-tile columns; edges are
# padded with zeros
ZERO_TILE_CASES = [
    # 2 x 3 spike tiles (rows 0-63, 64-69; k 0-63, 64-127, 128-129), 2
    # output-tile columns (n 65): tiles (0, 0) and (1, 2) spike -> 4 empty
    (70, 130, 65, [(0, 0), (65, 129)], 4 * 2),
    (70, 130, 65, [], 6 * 2),
    # one spike in the ragged corner tile only: 5 of 6 empty, 1 column
    (70, 130, 64, [(69, 128)], 5),
    # a 64 x 64 input with one spike: nothing empty, whatever n
    (64, 64, 300, [(63, 63)], 0),
    # 1 x 1: one tile, empty, 3 columns (n 129)
    (1, 1, 129, [], 3),
    # spikes along the diagonal of a 128 x 128: tiles (0, 0) and (1, 1)
    (128, 128, 64, [(i, i) for i in range(128)], 2),
]


@pytest.mark.parametrize("m,k,n,cells,expect", ZERO_TILE_CASES)
def test_zero_tiles_counts_by_hand(m, k, n, cells, expect):
    assert (p_mm.TILE_M, p_mm.TILE_N, p_mm.TILE_K) == (64, 64, 64)
    assert p_mm.zero_tiles(_ones_at((m, k), cells), n) == expect


VGG_MM_SHAPES = [(8192, 576, 64), (2048, 576, 128), (2048, 1152, 128),
                 (512, 1152, 256), (512, 2304, 256), (128, 2304, 512),
                 (128, 4608, 512), (32, 4608, 512)]


@pytest.mark.parametrize("m,k,n", VGG_MM_SHAPES + [(32, 64, 16), (65, 17, 63),
                                                   (5, 0, 5)])
def test_splits_cover_k_and_fill_the_card(m, k, n):
    """K is cut into ranges of whole k-steps, none empty, only when there
    are fewer than SPLIT_BELOW output tiles, and then into enough ranges to
    give at least half of SPLIT_BELOW blocks (or one range a step)."""
    n_split, per = p_mm.splits(m, k, n)
    steps = -(-k // p_mm.TILE_K)
    tiles = -(-m // p_mm.TILE_M) * -(-n // p_mm.TILE_N)
    assert n_split >= 1 and per >= 1
    assert (n_split - 1) * per < max(steps, 1) <= n_split * per
    if tiles >= p_mm.SPLIT_BELOW:
        assert n_split == 1
    else:
        assert (tiles * n_split >= p_mm.SPLIT_BELOW // 2
                or n_split == max(steps, 1))


def test_splits_of_the_deep_vgg16_layers():
    assert p_mm.splits(32, 4608, 512) == (15, 5)     # 8 tiles x 15 = 120
    assert p_mm.splits(128, 4608, 512) == (8, 9)     # 16 x 8 = 128
    assert p_mm.splits(8192, 576, 64) == (1, 9)      # 128 tiles: no split


def _vgg16_im2col_weights():
    """[K, N] float32 weights of Spike-VGG16's spiking convs at their
    initial values, laid out as ``spike_conv`` hands them to the kernel."""
    from repro_torch.snn import models
    cfg = models.spike_vgg16()
    net = models.init_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = []
    for b in cfg.blocks[1:]:
        if isinstance(b, models.ConvBNLif):
            w = net[b.name]["conv"]["w"].detach().permute(2, 3, 1, 0)
            out.append((b.name, p_ops.im2col(torch.zeros(1, 3, 3, b.cin),
                                             w.contiguous())[1]))
    return out


def test_split_bf16_is_exact_on_vgg16_weights():
    """The kernel's three-term bf16 split of each float32 weight of
    Spike-VGG16 at initialisation: the terms sum to the weight exactly, and
    their products on spikes of density 0.15, in float64, equal the float32
    weights' products within float64 rounding (1e-12 of the sum of absolute
    terms); two terms alone miss that by far."""
    rng = np.random.default_rng(0)
    weights = _vgg16_im2col_weights()
    assert len(weights) == 12
    for name, w in weights:
        assert w.dtype == torch.float32
        hi, mid, lo = p_mm.split_bf16(w)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        assert bool((w.abs() >= 2.0 ** -110).all()), name
        assert torch.equal(hi.float() + mid.float() + lo.float(), w), name
        w64 = w.double()
        terms = [t.double() for t in (hi, mid, lo)]
        sp = torch.as_tensor((rng.random((64, w.shape[0])) < 0.15)
                             .astype(np.float64))
        want = sp @ w64
        scale = sp.abs() @ w64.abs()
        got = sum(sp @ t for t in terms)
        assert bool(((got - want).abs() <= 1e-12 * scale).all()), name
        two = (sp @ terms[0] + sp @ terms[1] - want).abs()
        assert bool((two > 1e-7 * scale).any()), name


@pytest.mark.parametrize("hw", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_spike_conv_matches_reference(hw, stride):
    rng = np.random.default_rng(hw * 10 + stride)
    sp = (rng.random((2, hw, hw, 4)) < 0.25).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    out = p_ops.spike_conv(torch.as_tensor(sp), torch.as_tensor(w), stride)
    ref = r_ops.spike_conv(jnp.asarray(sp), jnp.asarray(w), stride)
    assert out.shape == ref.shape == (2, -(-hw // stride), -(-hw // stride), 8)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


def test_same_pads_are_xla_same():
    """At in_res=32: the ResNet stem (k=7, s=2) pads 2/3, the stem pool
    (k=3, s=2) 0/1 of its 16x16 map, a stage's 3x3 stride-2 conv 0/1, and a
    2x2 pool of a 1x1 map 0/1."""
    assert p_ops.same_pads(32, 7, 2) == (2, 3)
    assert p_ops.same_pads(16, 3, 2) == (0, 1)
    assert p_ops.same_pads(8, 3, 2) == (0, 1)
    assert p_ops.same_pads(1, 2, 2) == (0, 1)
    assert p_ops.same_pads(32, 3, 1) == (1, 1)
    assert p_ops.same_pads(32, 2, 2) == (0, 0)


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    """CPU tensors never launch a kernel (the counters stay put)."""
    before = (lif_step_kernel.launches, spike_matmul_kernel.launches)
    x = torch.ones(4, 8)
    p_ops.lif_step(x, x, x)
    p_ops.spike_matmul(x, x.t())
    assert (lif_step_kernel.launches, spike_matmul_kernel.launches) == before
