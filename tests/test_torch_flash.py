"""The port's flash attention against the JAX package, on the CPU.

``repro_torch.kernels.ops.flash_attention`` runs its kernel's plain version
for CPU tensors; it is held here against the reference's
``ops.flash_attention`` (the Pallas kernel in interpret mode) at the
reference sweep's shapes (``tests/test_kernels.py``), on the same inputs
made with numpy. Tolerances: float32 within atol=rtol=2e-5 (both compute a
float32 softmax; the sums run in another order); bfloat16 within
atol=rtol=1e-2 of the reference's bfloat16 output (about two roundings of a
value near 1 at bfloat16's 2^-8 relative step). The CUDA kernel itself is
held against the plain version on the card (``test_torch_kernels_gpu.py``).

The backward: ``flash_attention_backward_plain``, the model's CPU route
(``layers._Flash``, the reference's custom VJP per q chunk) and the
whole-sequence ``layers._FlashAttention`` on CPU tensors are held against
``jax.vjp`` of the reference's ``blockwise_attention`` (which runs its own
custom VJP) within rtol 1e-4 / atol 1e-6 (float32), and the plain lse
against the reference's ``_flash_fwd_impl`` within 2e-5.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro_torch.kernels import flash_attention as p_fa  # noqa: E402
from repro_torch.kernels import ops as p_ops  # noqa: E402
from repro_torch.kernels import ref as p_ref  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, s, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s,d,h,hkv", [(128, 64, 4, 4), (160, 48, 4, 2),
                                       (256, 128, 2, 1)])
@pytest.mark.parametrize("window", [None, 37])
def test_flash_attention_matches_reference_kernel(s, d, h, hkv, window):
    q, k, v = _qkv(s + d, 2, h, hkv, s, d)
    want = r_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window,
                                 block_q=64, block_k=64)
    got = p_ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), causal=True,
                                window=window, block_q=64, block_k=64)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_bf16_matches_reference_kernel():
    q, k, v = _qkv(3, 1, 2, 2, 128, 64)
    to_j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    to_t = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    want = r_ops.flash_attention(to_j(q), to_j(k), to_j(v), block_q=64,
                                 block_k=64)
    got = p_ops.flash_attention(to_t(q), to_t(k), to_t(v), block_q=64,
                                block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("s,window,causal", [(77, None, True), (77, 5, True),
                                             (128, None, False),
                                             (128, 40, False)])
def test_plain_version_matches_reference_oracle(s, window, causal):
    """``ref.attention_ref`` under the reference's name, any S, causal or
    not, with a window: the reference's dense oracle within float32
    tolerance."""
    q, k, v = _qkv(s, 2, 4, 2, s, 16)
    want = r_ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window)
    got = p_ref.attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_gqa_map_equals_repeated_heads():
    """Head h reads kv head h // (H / Hkv): the same as repeating K/V along
    heads (``jnp.repeat``), which the model's ``repeat_kv`` does."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(5, 2, 8, 2, 50, 16))
    grouped = p_fa.flash_attention_plain(q, k, v, window=9)
    repeated = p_fa.flash_attention_plain(q, k.repeat_interleave(4, dim=1),
                                          v.repeat_interleave(4, dim=1),
                                          window=9)
    assert torch.equal(grouped, repeated)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.as_tensor(a) for a in _qkv(7, 1, 2, 1, 33, 8))
    before = p_fa.flash_attention_kernel.launches
    out = torch.empty(1, 33, 2, 8).transpose(1, 2)        # strided out
    got = p_fa.flash_attention_kernel(q, k, v, window=4, out=out)
    assert got is out
    assert p_fa.flash_attention_kernel.launches == before
    assert torch.equal(out, p_fa.flash_attention_plain(q, k, v, window=4))


def test_contract_errors():
    q, k, v = (torch.as_tensor(a) for a in _qkv(8, 1, 4, 2, 96, 8))
    with pytest.raises(ValueError, match="non-causal"):
        p_ops.flash_attention(q, k, v, causal=False)      # 96 % 128 != 0
    p_ops.flash_attention(q, k, v, causal=False, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        p_ops.flash_attention(q, k[:, :1].expand(1, 3, 96, 8), v)
    with pytest.raises(ValueError, match="window"):
        p_ops.flash_attention(q, k, v, window=0)


@pytest.mark.parametrize("s,causal,window", [(1, True, None), (37, True, None),
                                             (37, True, 5), (64, False, 10),
                                             (64, False, None), (20, True, 64),
                                             (20, False, 64), (33, False, 1),
                                             (33, True, 1)])
def test_visible_pairs_counts_the_mask(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    assert p_fa.visible_pairs(s, causal, window) == int(mask.sum())


@pytest.mark.parametrize("dtypes,kw", [
    (("float32",) * 3, dict(interpret=True)),
    (("float16",) * 3, dict(interpret=True, window=37)),
    (("bfloat16", "float32", "float32"), dict(interpret=None)),
    (("float32", "bfloat16", "float16"), dict(interpret=True, window=20)),
])
def test_flash_attention_takes_reference_keywords_and_dtypes(dtypes, kw):
    """The reference's ``interpret`` keyword is accepted (and ignored), and
    float16 or mixed q/k/v run as the reference runs them: every input cast
    to float32, the result in ``q.dtype``. float32 within this file's 2e-5;
    a half-width ``q`` within one rounding of its dtype (1e-2)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
    arrays = _qkv(11, 1, 4, 2, 128, 32)
    want = r_ops.flash_attention(
        *(jnp.asarray(a).astype(jd[d]) for a, d in zip(arrays, dtypes)),
        block_q=64, block_k=64, **kw)
    got = p_ops.flash_attention(
        *(torch.as_tensor(a).to(td[d]) for a, d in zip(arrays, dtypes)),
        block_q=64, block_k=64, **kw)
    assert got.dtype == td[dtypes[0]] and got.shape == arrays[0].shape
    tol = 2e-5 if dtypes[0] == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---- the backward (the reference's custom VJP) ----------------------------------

def _bshd_inputs(seed, s, h, hkv, d=16):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((2, s, h, d)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((2, s, hkv, d)) * 0.4).astype(np.float32)
    v = rng.standard_normal((2, s, hkv, d)).astype(np.float32)
    g = rng.standard_normal((2, s, h, d)).astype(np.float32)
    return q, k, v, g


def _reference_vjp(q, k, v, g, window):
    @jax.jit
    def f(q, k, v, g):
        out, vjp = jax.vjp(lambda *a: r_layers.blockwise_attention(
            *a, window=window, q_chunk=64, k_chunk=32), q, k, v)
        return (out,) + vjp(g)
    return [np.asarray(x) for x in f(*(jnp.asarray(a) for a in (q, k, v, g)))]


@pytest.mark.parametrize("s", [17, 64, 160])
@pytest.mark.parametrize("window", [None, 23])
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_backward_matches_reference_vjp(s, window, h, hkv):
    """The plain backward, the CPU Function of the model (q chunks of 64,
    kv sub-chunks of 32) and the whole-sequence Function on CPU tensors,
    each against ``jax.vjp`` of the reference's blockwise attention."""
    _check_backward_against_reference(s, window, h, hkv, 16, atol=1e-6)


@pytest.mark.parametrize("d", [160, 192])
@pytest.mark.parametrize("s", [17, 160])
@pytest.mark.parametrize("window", [None, 23])
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_backward_wide_head_dims_match_reference_vjp(d, s, window, h, hkv):
    """As above at zamba2's D 160 and deepseek-v3's D 192, the head dims
    of the card's wide tensor-core backward, which is held against this
    plain version there: its chain back to the reference. atol 5e-6: dq
    sums 160 keys of 192-long float32 products in another order than the
    reference, about 1e-6 off on gradients near 1 (rtol 1e-4 as above)."""
    _check_backward_against_reference(s, window, h, hkv, d, atol=5e-6)


def _check_backward_against_reference(s, window, h, hkv, d, atol):
    q, k, v, g = _bshd_inputs(s + h + hkv, s, h, hkv, d)
    want = _reference_vjp(q, k, v, g, window)

    def check(got):
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4,
                                       atol=atol)

    bhsd = [torch.tensor(a).transpose(1, 2) for a in (q, k, v, g)]
    lse = torch.empty(2, h, s)
    out = p_fa.flash_attention_plain(*bhsd[:3], window=window, lse=lse)
    grads = p_fa.flash_attention_backward_plain(*bhsd[:3], out, bhsd[3], lse,
                                                window=window)
    check([t.transpose(1, 2).numpy() for t in (out,) + grads])
    for fn in (lambda *t: p_layers.blockwise_attention(
                   *t, window=window, q_chunk=64, k_chunk=32),
               lambda *t: p_layers._FlashAttention.apply(*t, window)):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, torch.tensor(g))
        check([out.detach().numpy()] + [t.numpy() for t in grads])


@pytest.mark.parametrize("s", [17, 64, 160])
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_noncausal_whole_sequence_function_matches_reference_vjp(s, h, hkv):
    """The whole-sequence Function with ``causal=False`` (the enc-dec
    encoder's and equal-length cross-attention's route on the card) on CPU
    tensors, forward and gradients, against ``jax.vjp`` of the reference's
    non-causal blockwise attention (rtol 1e-4, atol 1e-6)."""
    q, k, v, g = _bshd_inputs(s + h + hkv, s, h, hkv)

    def ref(q, k, v):
        return r_layers.blockwise_attention(q, k, v, causal=False,
                                            q_chunk=64, k_chunk=32)

    out, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want = (out,) + vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = p_layers._FlashAttention.apply(*leaves, None, False)
    grads = torch.autograd.grad(got, leaves, torch.tensor(g))
    for a, b in zip([got.detach()] + list(grads), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


class _Stand:
    """The shape and device that a ``_kernel_route`` decision reads, on a
    device that this host need not have."""

    def __init__(self, device, b, s, h, d):
        self.shape = (b, s, h, d)
        self.device = torch.device(device)


@pytest.mark.parametrize("device,s,skv,pos_offset,causal,window,kernel", [
    ("cuda", 128, 128, 0, True, None, True),     # causal self-attention
    ("cuda", 128, 128, 0, True, 37, True),       # ... with a window
    ("cuda", 128, 128, 0, False, None, True),    # encoder; S_dec == S_enc
    ("cuda", 100, 128, 0, False, None, False),   # cross, S_q != S_kv
    ("cuda", 1, 128, 0, False, None, False),     # cross-attention in decode
    ("cuda", 128, 128, 0, False, 37, False),     # non-causal with a window
    ("cuda", 128, 160, 32, True, None, False),   # a q block past the start
    ("cpu", 128, 128, 0, False, None, False),    # CPU tensors
    ("cpu", 128, 128, 0, True, None, False),
])
def test_kernel_route_takes_equal_length_attention(device, s, skv,
                                                   pos_offset, causal,
                                                   window, kernel):
    """On CUDA tensors the flash kernels take causal self-attention and
    non-causal attention with ``S_q == S_kv``, no window, at offset 0;
    ``S_q != S_kv`` cross-attention, a window on non-causal attention and
    an offset stay on the reference's chunked ``_Flash``, as does every
    CPU tensor."""
    q, k = _Stand(device, 2, s, 4, 16), _Stand(device, 2, skv, 4, 16)
    assert p_layers._kernel_route(q, k, pos_offset, causal, window) is kernel


@pytest.mark.parametrize("s,window", [(40, None), (77, 24)])
def test_plain_lse_matches_reference(s, window):
    q, k, v, _ = _bshd_inputs(s, s, 4, 2)
    _, want = r_layers._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), 0, 0, window, True, s)
    lse = torch.empty(2, 4, s)
    p_fa.flash_attention_plain(*(torch.tensor(a).transpose(1, 2)
                                 for a in (q, k, v)), window=window, lse=lse)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want).reshape(2, 4, s), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("route", ["chunks", "whole"])
def test_attention_saves_only_the_custom_vjp_residuals(route):
    """Under autograd the attention keeps ``(q, k, v, out, lse)`` (k and v
    as the kv slices of each q chunk) and no score block: the memory of the
    reference's custom VJP, not of differentiating the online-softmax
    loop."""
    s, h, hkv, d = 96, 4, 2, 16
    q, k, v, _ = _bshd_inputs(0, s, h, hkv, d)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        if route == "chunks":
            p_layers.blockwise_attention(*leaves, q_chunk=32, k_chunk=32)
        else:
            p_layers._FlashAttention.apply(*leaves, None)
    allowed = {(2, c, n, d) for c in range(1, s + 1) for n in (h, hkv)}
    allowed |= {(2, hkv, h // hkv, 32), (2, h, s)}          # lse
    assert saved and set(saved) <= allowed, set(saved) - allowed
    assert len(saved) == 5 * (3 if route == "chunks" else 1)
