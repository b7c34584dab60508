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
