"""The port's Mamba2 (SSD) and xLSTM cells and blocks against the JAX
package, on the CPU (``tests/test_ssm.py``'s cases, held across packages).

Inputs are made with numpy from a seed and handed to both packages;
block weights are the reference's, carried across. Tolerances (float32):
the SSD scans, their decode step and the sLSTM cell within atol 1e-5 (the
same sums in another order); the mLSTM scans within 3e-5 (the reference's
own bound for its single-chunk case against the stepwise recurrence); the
blocks within 2e-5 (a projection more on either side).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as r_m  # noqa: E402
from repro.models import xlstm as r_x  # noqa: E402
from repro_torch.models import mamba2 as p_m  # noqa: E402
from repro_torch.models import specs as p_specs  # noqa: E402
from repro_torch.models import xlstm as p_x  # noqa: E402

SSD_ATOL = 1e-5
MLSTM_ATOL = 3e-5
BLOCK_ATOL = 2e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# ---- SSD ---------------------------------------------------------------------

def _ssd_inputs(b=2, s=64, h=3, p=8, g=1, n=4, seed=0):
    """``tests/test_ssm.py``'s shapes and scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) * 0.5)).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


# the reference's functions under jit (faster on the CPU than eager scans)
_R_SSD_STEP = jax.jit(r_m.ssd_step)
_R_SSD = jax.jit(r_m.ssd_chunked, static_argnums=5)
_R_MLSTM = {fn: jax.jit(getattr(r_x, fn), static_argnames="chunk")
            for fn in ("mlstm_scan", "mlstm_scan_recurrent")}


def _ssd_steps(pkg, x, dt, a, bm, cm):
    """A package's ``ssd_step`` over every position, from a zero state."""
    to, zeros, step = ((jnp.asarray, jnp.zeros, _R_SSD_STEP) if pkg is r_m
                       else (_t, torch.zeros, p_m.ssd_step))
    b, s, h, p = x.shape
    state = zeros((b, h, p, bm.shape[-1]))
    ys = []
    for t in range(s):
        state, y = step(state, *(to(v) for v in (
            x[:, t], dt[:, t], a, bm[:, t], cm[:, t])))
        ys.append(np.asarray(y))
    return np.stack(ys, axis=1), np.asarray(state)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_and_step_match_reference(chunk):
    inputs = _ssd_inputs()
    want, want_h = _R_SSD(*map(jnp.asarray, inputs), chunk)
    got, got_h = p_m.ssd_chunked(*map(_t, inputs), chunk)
    _close(got, want, SSD_ATOL)
    _close(got_h, want_h, SSD_ATOL)
    # the decode step over every position: the recurrence the chunked form
    # must equal (tests/test_ssm.py's oracle, atol 1e-4 there)
    r_y, r_h = _ssd_steps(r_m, *inputs)
    p_y, p_h = _ssd_steps(p_m, *inputs)
    np.testing.assert_allclose(p_y, r_y, atol=SSD_ATOL)
    np.testing.assert_allclose(p_h, r_h, atol=SSD_ATOL)
    np.testing.assert_allclose(got.numpy(), p_y, atol=1e-4)


def test_ssd_chunk_size_invariance_and_bad_length():
    inputs = _ssd_inputs(s=48, seed=1)
    y8, _ = p_m.ssd_chunked(*map(_t, inputs), 8)
    y24, _ = p_m.ssd_chunked(*map(_t, inputs), 24)
    np.testing.assert_allclose(y8.numpy(), y24.numpy(), atol=1e-4)
    _close(y24, _R_SSD(*map(jnp.asarray, inputs), 24)[0], SSD_ATOL)
    # the reference asserts S % min(chunk, S) == 0; the port raises there
    with pytest.raises(ValueError, match="multiple of the chunk"):
        p_m.ssd_chunked(*map(_t, inputs), 32)


def test_ssd_grouped_heads():
    """h=4 over g=2 groups: head h reads group h // 2 (``jnp.repeat``, i.e.
    ``repeat_interleave``)."""
    inputs = _ssd_inputs(h=4, g=2, seed=2)
    want, _ = _R_SSD(*map(jnp.asarray, inputs), 16)
    got, _ = p_m.ssd_chunked(*map(_t, inputs), 16)
    _close(got, want, SSD_ATOL)
    r_y, _ = _ssd_steps(r_m, *inputs)
    np.testing.assert_allclose(got.numpy(), r_y, atol=1e-4)


def test_ssd_state_decays():
    """With strongly negative A, the first token's influence on the last
    output decays (the reference's property), and the outputs are the
    reference's."""
    x, dt, a, bm, cm = _ssd_inputs(s=32, seed=3)
    a = np.full_like(a, -5.0)
    y, _ = p_m.ssd_chunked(*map(_t, (x, dt, a, bm, cm)), 8)
    x2 = x.copy()
    x2[:, 0] += 100.0
    y2, _ = p_m.ssd_chunked(*map(_t, (x2, dt, a, bm, cm)), 8)
    late = (y2[:, -1] - y[:, -1]).abs().max().item()
    early = (y2[:, 0] - y[:, 0]).abs().max().item()
    assert late < 1e-3 * early
    _close(y2, _R_SSD(*map(jnp.asarray, (x2, dt, a, bm, cm)), 8)[0],
           SSD_ATOL * 100)    # outputs up to ~100: the same relative bound


def test_segsum_gradient_is_finite_where_the_reference_overflows():
    """Steep decays (log-decay -10 a step over 16 steps) put masked
    ``a_cum_i - a_cum_j`` past float32's exp range: the port's decay matrix
    has the reference's values, and its gradient is finite, where the
    reference's ``where(mask, exp(diff), 0)`` gives 0 x inf = NaN (a
    reference-side fault; zamba2's smoke loss reaches it)."""
    rng = np.random.default_rng(15)
    a_cum = np.cumsum(-10.0 - rng.random((2, 16)), axis=-1).astype(np.float32)
    w = rng.standard_normal((2, 16, 16)).astype(np.float32)
    want = r_m._segsum_mask(jnp.asarray(a_cum))
    r_grad = jax.grad(lambda a: (r_m._segsum_mask(a) * w).sum())(
        jnp.asarray(a_cum))
    x = _t(a_cum).requires_grad_()
    got = p_m._segsum_mask(x)
    (p_grad,) = torch.autograd.grad((got * _t(w)).sum(), x)
    # the values: the reference's within an ulp of exp; below float32's
    # smallest normal number XLA flushes to zero where torch keeps subnormals
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=np.finfo(np.float32).tiny)
    assert bool(np.isnan(np.asarray(r_grad)).any())
    assert bool(torch.isfinite(p_grad).all())
    # the reference's values with the masked entries exponentiated as
    # exp(-inf) = 0: its gradient where it is finite
    vis = np.tril(np.ones((16, 16), bool))
    r_vis = jax.grad(lambda a: (jnp.exp(jnp.where(
        vis, a[..., :, None] - a[..., None, :], -jnp.inf)) * w).sum())(
        jnp.asarray(a_cum))
    np.testing.assert_allclose(p_grad.numpy(), np.asarray(r_vis), rtol=1e-5,
                               atol=1e-5)


# ---- mLSTM -------------------------------------------------------------------

def _mlstm_inputs(b=2, s=48, h=2, dh=8, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = (rng.standard_normal((b, s, h, dh)) / np.sqrt(dh)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    ig = rng.standard_normal((b, s, h)).astype(np.float32)
    fg = (rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _check_mlstm(fn, inputs, chunk):
    want, want_st = _R_MLSTM[fn](*map(jnp.asarray, inputs), chunk=chunk)
    got, got_st = getattr(p_x, fn)(*map(_t, inputs), chunk=chunk)
    assert got.shape == want.shape
    _close(got, want, MLSTM_ATOL)
    for a, b in zip(got_st, want_st):
        _close(a, b, MLSTM_ATOL)
    return got


@pytest.mark.parametrize("chunk", [4, 16, 48])
def test_mlstm_scan_matches_reference(chunk):
    got = _check_mlstm("mlstm_scan", _mlstm_inputs(), chunk)
    steps = _check_mlstm("mlstm_scan_recurrent", _mlstm_inputs(), chunk)
    np.testing.assert_allclose(got.numpy(), steps.numpy(), atol=MLSTM_ATOL)


def test_mlstm_stabilizer_handles_large_gates():
    """Input gates +40 (exp(40) would overflow a naive form): finite, and
    the reference's values."""
    q, k, v, ig, fg = _mlstm_inputs(s=16, seed=8)
    got = _check_mlstm("mlstm_scan", (q, k, v, ig + 40.0, fg), 8)
    assert bool(torch.isfinite(got).all())


def test_mlstm_cell_step_matches_reference():
    q, k, v, ig, fg = _mlstm_inputs(s=5, seed=9)
    rng = np.random.default_rng(10)
    b, _, h, dh = q.shape
    state = (rng.standard_normal((b, h, dh, dh)).astype(np.float32),
             rng.standard_normal((b, h, dh)).astype(np.float32),
             rng.standard_normal((b, h)).astype(np.float32))
    r_st, p_st = tuple(map(jnp.asarray, state)), tuple(map(_t, state))
    for t in range(q.shape[1]):
        inp = (q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        r_st, want = r_x._mlstm_cell_step(r_st, tuple(map(jnp.asarray, inp)))
        p_st, got = p_x._mlstm_cell_step(p_st, tuple(map(_t, inp)))
        _close(got, want, MLSTM_ATOL)
    for a, b_ in zip(p_st, r_st):
        _close(a, b_, MLSTM_ATOL)


# ---- sLSTM -------------------------------------------------------------------

def test_slstm_cell_matches_reference_and_is_bounded():
    """20 steps from the fresh state (m at -1e30), the reference's
    ``test_slstm_cell_bounded`` shapes: each step's output and the final
    state within 1e-5, and bounded by ~max|z|."""
    b, h, dh = 2, 2, 8
    rng = np.random.default_rng(11)
    r = (rng.standard_normal((h, dh, 4 * dh)) * 0.1).astype(np.float32)
    bg = np.zeros((h, 4 * dh), np.float32)
    zeros = np.zeros((b, h, dh), np.float32)
    state = (zeros,) * 3 + (np.full((b, h, dh), -1e30, np.float32),)
    r_st, p_st = tuple(map(jnp.asarray, state)), tuple(map(_t, state))
    for _ in range(20):
        wx = rng.standard_normal((b, h, 4 * dh)).astype(np.float32)
        r_st, want = r_x._slstm_cell_step((jnp.asarray(r), jnp.asarray(bg)),
                                          r_st, jnp.asarray(wx))
        p_st, got = p_x._slstm_cell_step((_t(r), _t(bg)), p_st, _t(wx))
        _close(got, want, SSD_ATOL)
    for a, b_ in zip(p_st, r_st):
        _close(a, b_, SSD_ATOL)
    assert bool(torch.isfinite(got).all()) and got.abs().max().item() < 5.0


# ---- blocks with carried weights -------------------------------------------------

D = 64
SSM = dict(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16)
XL = dict(n_heads=4, chunk=8)


def _weights(r_specs_tree, p_specs_tree, seed):
    """Weights drawn by the port from ``seed`` under its specs, which must
    have the reference's shapes; returned as the reference's arrays."""
    for (path, a), (_, b) in zip(p_specs.tree_leaves(p_specs_tree),
                                 p_specs.tree_leaves(r_specs_tree)):
        assert a.shape == b.shape, path
    drawn = p_specs.materialize(p_specs_tree,
                                torch.Generator().manual_seed(seed),
                                device="cpu")
    return p_specs.tree_map(lambda t: jnp.asarray(t.numpy()), drawn)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _block(kind):
    """(reference fn, port fn, the reference's weights, a cache of numpy
    arrays) for one block at D=64, batch 2, float32. The cache holds small
    seeded values, not zeros, so that a prefill that starts from its cache
    (the xLSTM blocks) is seen to."""
    if kind == "mamba2":
        rc, pc = r_m.SSMConfig(**SSM), p_m.SSMConfig(**SSM)
        rp = _weights(r_m.mamba_specs(D, rc, jnp.float32),
                      p_m.mamba_specs(D, pc, torch.float32), 1)
        h = r_m.n_heads_ssm(D, rc)
        conv = r_m.d_inner(D, rc) + 2 * rc.n_groups * rc.d_state
        shapes = {"h": (2, h, rc.head_dim, rc.d_state),
                  "conv": (2, rc.d_conv - 1, conv)}

        @jax.jit
        def r_fn(p, x, c):
            return r_m.mamba_block(p, x, None, rc, c)

        def p_fn(p, x, c):
            return p_m.mamba_block(p, x, None, pc, c)
    else:
        rc, pc = r_x.XLSTMConfig(**XL), p_x.XLSTMConfig(**XL)
        rp = _weights(getattr(r_x, f"{kind}_specs")(D, rc, jnp.float32),
                      getattr(p_x, f"{kind}_specs")(D, pc, torch.float32), 2)
        if kind == "mlstm":
            dh = int(D * rc.up_factor) // rc.n_heads
            shapes = {"c": (2, 4, dh, dh), "n": (2, 4, dh), "m": (2, 4)}
        else:
            shapes = {k: (2, 4, D // 4) for k in "hcnm"}
        r_blk = getattr(r_x, f"{kind}_block")
        p_blk = getattr(p_x, f"{kind}_block")

        @jax.jit
        def r_fn(p, x, c):
            return r_blk(p, x, rc, c)

        def p_fn(p, x, c):
            return p_blk(p, x, pc, c)
    rng = np.random.default_rng(12)
    cache = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
    return r_fn, p_fn, rp, cache


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_block_without_cache_matches_reference(kind):
    r_fn, p_fn, rp, _ = _block(kind)
    x = (np.random.default_rng(13).standard_normal((2, 32, D))
         .astype(np.float32))
    want, r_none = r_fn(rp, jnp.asarray(x), None)
    got, p_none = p_fn(_to_torch(rp), _t(x), None)
    assert r_none is None and p_none is None
    _close(got, want, BLOCK_ATOL)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_block_prefill_then_decode_matches_reference(kind):
    """Prefill 32 positions into the cache, then three decode steps: every
    output and the cache after each call within tolerance; the port writes
    its cache in place and returns the same dict."""
    r_fn, p_fn, rp, cache = _block(kind)
    pp = _to_torch(rp)
    x = (np.random.default_rng(14).standard_normal((2, 35, D))
         .astype(np.float32))
    r_c = {k: jnp.asarray(v) for k, v in cache.items()}
    p_c = {k: _t(v) for k, v in cache.items()}
    for lo, hi in ((0, 32), (32, 33), (33, 34), (34, 35)):
        want, r_c = r_fn(rp, jnp.asarray(x[:, lo:hi]), r_c)
        got, out = p_fn(pp, _t(x[:, lo:hi]), p_c)
        assert out is p_c
        _close(got, want, BLOCK_ATOL)
        for k in cache:
            _close(p_c[k], r_c[k], BLOCK_ATOL)
