"""The port's SNN kernel entry points (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops``, Pallas in interpret mode on the CPU).

On CPU tensors each wrapper runs its kernel's plain version, so these tests
hold the plain versions, the im2col layout and the SAME padding of
``spike_conv`` against the reference; the kernels themselves are held
against the plain versions on the card (``tests/test_torch_kernels_gpu.py``).
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference kernel tests' own (``tests/test_kernels.py``),
tightened to rtol 1e-6 for float32 LIF, whose plain version computes in the
reference's order. The LIF backward's plain version is held against
``jax.vjp`` of the reference's ``lif_step``: float32 within rtol 1e-6,
atol 1e-7; bfloat16 within 2^-5 of each result's largest magnitude (XLA and
PyTorch round bfloat16 intermediates at different places, which moves the
sigmoid and atan surrogates by up to two bfloat16 steps).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops, ref as r_ref  # noqa: E402
from repro.snn import neurons as r_neurons  # noqa: E402
from repro_torch.kernels import ops as p_ops, ref as p_ref  # noqa: E402
from repro_torch.kernels.lif import (lif_backward_kernel,  # noqa: E402
                                     lif_backward_plain, lif_step_kernel)
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


def _lif_backward_case(shape, seed, dtype, cfg):
    """Inputs of one LIF update and its cotangents as numpy float32 (bf16
    values when ``dtype`` is bfloat16), the reference's ``u'`` and its
    ``vjp`` function."""
    rng = np.random.default_rng(seed)
    jd = DTYPES[dtype][0]
    raw = [rng.standard_normal(shape) * 1.5, rng.random(shape) < 0.3,
           rng.standard_normal(shape), rng.standard_normal(shape),
           rng.standard_normal(shape)]
    u, s, c, gu, gs = (np.array(jnp.asarray(a.astype(np.float32), jd),
                                np.float32) for a in raw)
    (un, _), vjp = jax.vjp(
        lambda a, b, d: r_neurons.lif_step(a, b, d, cfg),
        *(jnp.asarray(a, jd) for a in (u, s, c)))
    return u, s, gu, gs, np.array(un, np.float32), vjp


@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("surrogate", ["rect", "sigmoid", "atan"])
@pytest.mark.parametrize("present", ["both", "g_u", "g_s"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lif_backward_plain_matches_reference_vjp(reset, surrogate, present,
                                                  dtype):
    """The plain backward against ``jax.vjp`` of the reference's LIF update,
    with one cotangent absent where ``present`` says so (a zero cotangent
    for the reference): d_u, d_s and g (the cotangent of I)."""
    cfg = dict(reset=reset, surrogate=surrogate, decay=0.7)
    u, s, gu, gs, un, vjp = _lif_backward_case(
        (4, 33, 17), len(present) + 7 * len(surrogate), dtype,
        r_neurons.LIFConfig(**cfg))
    jd, td = DTYPES[dtype]
    zero = np.zeros_like(gu)
    want = vjp(tuple(jnp.asarray(g if present in ("both", name) else zero, jd)
                     for g, name in ((gu, "g_u"), (gs, "g_s"))))
    t = {k: torch.as_tensor(v).to(td) for k, v in
         dict(u=u, s=s, gu=gu, gs=gs, un=un).items()}
    kw = dict(threshold=1.0, decay=0.7, reset=reset, surrogate=surrogate,
              alpha=2.0)
    got = lif_backward_plain(t["gu"] if present != "g_s" else None,
                             t["gs"] if present != "g_u" else None,
                             t["u"], t["s"], t["un"], **kw)
    for name, a, b in zip(("d_u", "d_s", "g"), got, want):
        assert a.dtype == td and a.shape == u.shape, name
        b = np.asarray(b, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(_np(a), b, rtol=0,
                                       atol=2**-5 * np.abs(b).max(),
                                       err_msg=name)
    # the wrapper takes the plain version on CPU tensors, launching nothing
    before = lif_backward_kernel.launches
    again = lif_backward_kernel(t["gu"] if present != "g_s" else None,
                                t["gs"] if present != "g_u" else None,
                                t["u"], t["s"], t["un"], **kw)
    assert lif_backward_kernel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_lif_backward_plain_need_flags_and_absent_cotangents():
    """``need_u`` / ``need_s`` drop d_u / d_s and nothing else; with only
    ``g_u`` the cotangent of I is ``g_u`` itself; with neither, all three
    are None; an unknown reset or surrogate raises."""
    rng = np.random.default_rng(11)
    gu, gs, u, un = (torch.as_tensor(rng.standard_normal(64)
                                     .astype(np.float32)) for _ in range(4))
    s = torch.as_tensor((rng.random(64) < 0.5).astype(np.float32))
    full = lif_backward_plain(gu, gs, u, s, un)
    for need_u, need_s in ((True, False), (False, True), (False, False)):
        d_u, d_s, g = lif_backward_kernel(gu, gs, u, s, un, need_u=need_u,
                                          need_s=need_s)
        assert (d_u is None) != need_u and (d_s is None) != need_s
        assert torch.equal(g, full[2])
        if need_u:
            assert torch.equal(d_u, full[0])
        if need_s:
            assert torch.equal(d_s, full[1])
    assert lif_backward_plain(gu, None, u, s, un)[2] is gu
    assert lif_backward_kernel(None, None, u, s, un) == (None, None, None)
    with pytest.raises(ValueError):
        lif_backward_kernel(gu, gs, u, s, un, reset="none")
    with pytest.raises(ValueError):
        lif_backward_kernel(gu, gs, u, s, un, surrogate="relu")


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


# ---- the reference's keywords and dtypes -------------------------------------

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def _as(x, dtype):
    return jnp.asarray(x).astype(JNP[dtype]), torch.as_tensor(x).to(
        TORCH[dtype])


@pytest.mark.parametrize("op,kw", [
    ("lif_step", dict(interpret=True)),
    ("lif_step", dict(interpret=None, threshold=0.7)),
    ("spike_matmul", dict(interpret=True, block_m=64, block_k=64,
                          block_n=64)),
    ("spike_matmul", dict(block_m=32, block_k=128, block_n=32)),
    ("spike_conv", dict(interpret=True)),
])
def test_ops_take_the_reference_keywords(op, kw):
    """Every keyword of the reference's ``ops`` is accepted by the port's
    (``interpret`` and the TPU block sizes are ignored), and the results
    agree with the reference's run with the same keywords (Pallas in
    interpret mode) at this file's tolerances."""
    rng = np.random.default_rng(len(kw))
    if op == "lif_step":
        args = [rng.standard_normal((8, 33)).astype(np.float32),
                (rng.random((8, 33)) < 0.3).astype(np.float32),
                rng.standard_normal((8, 33)).astype(np.float32)]
        u, s = r_ops.lif_step(*map(jnp.asarray, args), **kw)
        un, sn = p_ops.lif_step(*map(torch.as_tensor, args), **kw)
        np.testing.assert_array_equal(_np(sn), _np(s))
        np.testing.assert_allclose(_np(un), _np(u), rtol=1e-6)
        return
    if op == "spike_matmul":
        args = [(rng.random((70, 200)) < 0.2).astype(np.float32),
                rng.standard_normal((200, 90)).astype(np.float32)]
    else:
        args = [(rng.random((2, 7, 7, 4)) < 0.25).astype(np.float32),
                rng.standard_normal((3, 3, 4, 8)).astype(np.float32)]
    ref = getattr(r_ops, op)(*map(jnp.asarray, args), **kw)
    out = getattr(p_ops, op)(*map(torch.as_tensor, args), **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtypes", [("float16",) * 3,
                                    ("bfloat16", "float32", "float32"),
                                    ("float32", "bfloat16", "float16"),
                                    ("float16", "bfloat16", "float32")])
def test_lif_step_mixed_dtypes_match_reference(dtypes):
    """Mixed and float16 states: the reference casts each to float32 and
    returns ``u``'s dtype, and so does the port; spikes exact, the
    membrane within one rounding of ``u``'s dtype."""
    rng = np.random.default_rng(5)
    raw = [rng.standard_normal((6, 40)).astype(np.float32),
           (rng.random((6, 40)) < 0.3).astype(np.float32),
           rng.standard_normal((6, 40)).astype(np.float32)]
    pairs = [_as(x, d) for x, d in zip(raw, dtypes)]
    ur, sr = r_ops.lif_step(*(j for j, _ in pairs), reset="soft")
    un, sn = p_ops.lif_step(*(t for _, t in pairs), reset="soft")
    assert un.dtype == sn.dtype == TORCH[dtypes[0]]
    np.testing.assert_array_equal(_np(sn), _np(sr))
    tol = 1e-6 if dtypes[0] == "float32" else 1e-2
    np.testing.assert_allclose(_np(un), _np(ur), rtol=tol, atol=tol)


@pytest.mark.parametrize("sd,wd", [("float16", "float16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16"),
                                   ("float32", "float16")])
def test_spike_matmul_mixed_dtypes_match_reference(sd, wd):
    """Spikes and weights of any two dtypes: float32 sums returned in
    ``w.dtype``, within 1e-4 in float32 and within this file's bfloat16
    tolerance (5e-2) in the half-width types."""
    rng = np.random.default_rng(6)
    (js, ts) = _as((rng.random((48, 96)) < 0.2).astype(np.float32), sd)
    (jw, tw) = _as(rng.standard_normal((96, 40)).astype(np.float32), wd)
    ref = r_ops.spike_matmul(js, jw)
    out = p_ops.spike_matmul(ts, tw)
    assert out.dtype == TORCH[wd] and out.shape == (48, 40)
    tol = 1e-4 if wd == "float32" else 5e-2
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)
