"""The port's RoPE (``kernels/rope.py``, ``models.layers.apply_rope``) on the
CPU: the plain version against the torch ops ``apply_rope`` ran before the
kernel (``_ops`` below, kept as they were), forward and autograd's gradient
through them, bit for bit; and the routes: a CPU tensor takes the plain
version (through the kernel's Function), a fake tensor the custom op
``torch.ops.repro_torch.rope``, one op a call, launching nothing. The
kernel itself is held against the plain version on the card
(``test_torch_kernels_gpu.py``)."""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode, is_fake  # noqa: E402

from repro_torch.core import trace_analysis as TA  # noqa: E402
from repro_torch.kernels import rope as R  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


def _ops(x, positions, theta=1e4):
    """``apply_rope``'s torch ops before the kernel, unchanged."""
    d = x.shape[-1]
    freqs = R.rope_freqs(d, theta, x.device)           # [D/2]
    angles = positions[..., None].float() * freqs      # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]              # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# (name, x's base shape, the slice of its last dim RoPE takes, positions:
# "arange", ("at", p) for [p, p + S) or ("rows", hi) for random [B, S]
# int32 below hi, theta)
CASES = [
    ("internlm2_q", (2, 24, 16, 128), None, "arange", 1e6),
    ("internlm2_k", (2, 24, 8, 128), None, "arange", 1e6),
    ("minicpm3_q_rope", (2, 24, 8, 96), (64, 96), "arange", 1e4),
    ("minicpm3_k_rope", (2, 24, 1, 32), None, "arange", 1e4),
    ("deepseek_q_rope", (2, 24, 8, 192), (128, 192), "arange", 1e4),
    ("deepseek_k_rope", (2, 24, 1, 64), None, "arange", 1e4),
    ("seamless", (2, 24, 4, 64), None, "arange", 1e4),
    ("decode", (3, 1, 16, 128), None, ("at", 37), 1e6),
    ("rows", (3, 24, 4, 64), None, ("rows", 300_000), 1e4),
]
DTYPES = [torch.bfloat16, torch.float32]


def _inputs(case, dtype, seed=0):
    _, shape, cut, pos, theta = case
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 2).to(dtype)
    if cut is not None:
        x = x[..., cut[0]:cut[1]]
    b, s = shape[:2]
    if pos == "arange":
        positions = torch.arange(s)
    elif pos[0] == "at":
        positions = torch.full((1,), pos[1], dtype=torch.int64)
    else:
        positions = torch.randint(0, pos[1], (b, s), generator=gen,
                                  dtype=torch.int32)
    return x, positions, theta


def _bits(t):
    return t.view({torch.bfloat16: torch.int16, torch.float16: torch.int16,
                   torch.float32: torch.int32}[t.dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_is_bit_identical_to_the_ops_and_their_gradient(case, dtype):
    x, positions, theta = _inputs(case, dtype)
    if case[2] is not None:
        assert not x.is_contiguous() and x.stride(-1) == 1
    xg = x.detach().requires_grad_()
    want = _ops(xg, positions, theta)
    got = R.rope_plain(x, positions, theta)
    assert got.dtype == x.dtype and torch.equal(_bits(got), _bits(want))
    gen = torch.Generator().manual_seed(1)
    d = torch.randn(want.shape, generator=gen).to(dtype)
    d[:, :1] = 0.0                     # zero cotangents: the sign of zero
    (grad,) = torch.autograd.grad(want, xg, d)
    back = R.rope_plain(d, positions, theta, inverse=True)
    assert back.dtype == x.dtype and torch.equal(_bits(back), _bits(grad))


def test_inverse_turns_negative_zeros_positive_as_autograd_does():
    """A zero cotangent where cos and sin are both negative gives -0 in
    ``d1 cos + d2 sin``; autograd's sum with the zero-filled slice
    gradients gives +0, and so does the plain inverse."""
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    positions = torch.arange(8)
    d = torch.zeros(1, 8, 2, 16)
    (grad,) = torch.autograd.grad(_ops(x, positions), x, d)
    back = R.rope_plain(d, positions, inverse=True)
    assert not torch.signbit(grad).any()
    assert torch.equal(_bits(back), _bits(grad))


@pytest.mark.parametrize("case", CASES[:3] + CASES[7:], ids=lambda c: c[0])
def test_cpu_tensors_take_the_plain_version(case):
    """``apply_rope`` on CPU tensors goes through the kernel's Function,
    whose wrapper runs the torch ops on the CPU both ways: the output and
    the gradient are those of the ops and of autograd through them, bit
    for bit, and nothing is launched or counted."""
    x, positions, theta = _inputs(case, torch.bfloat16)
    launches = (R.rope_kernel.launches, R.rope_kernel.backward_launches)
    xg, xr = (x.detach().requires_grad_() for _ in range(2))
    got = L.apply_rope(xg, positions, theta)
    want = _ops(xr, positions, theta)
    assert type(got.grad_fn).__name__ == "_RopeBackward"
    assert torch.equal(_bits(got), _bits(want))
    d = torch.randn(want.shape, generator=torch.Generator().manual_seed(3)
                    ).to(x.dtype)
    (grad,) = torch.autograd.grad(got, xg, d)
    (grad_ops,) = torch.autograd.grad(want, xr, d)
    assert torch.equal(_bits(grad), _bits(grad_ops))
    assert torch.equal(R.rope_kernel(x, positions, theta),
                       R.rope_plain(x, positions, theta))
    assert (R.rope_kernel.launches,
            R.rope_kernel.backward_launches) == launches


def _fake_cuda(shape, dtype, stride=None):
    if stride is None:
        return torch.empty(shape, dtype=dtype, device="cuda")
    return torch.empty_strided(shape, stride, dtype=dtype, device="cuda")


# (x shape, its strides or None, positions shape, dtype)
FAKE = [
    ((32, 64, 16, 128), None, (64,), torch.bfloat16),
    ((2, 48, 8, 32), (48 * 8 * 96, 8 * 96, 96, 1), (48,), torch.bfloat16),
    ((2, 48, 1, 64), None, (2, 48), torch.float32),
    ((4, 1, 16, 128), None, (1,), torch.float16),
]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,stride,pshape,dtype", FAKE)
def test_fake_cuda_tensors_take_the_custom_op(shape, stride, pshape, dtype,
                                              inverse):
    """One ``repro_torch.rope`` op a call, with x and the positions in and a
    contiguous tensor of x's shape and dtype out; nothing launched."""
    fm = FakeTensorMode()
    with fm:
        x = _fake_cuda(shape, dtype, stride)
        positions = torch.empty(pshape, dtype=torch.int64, device="cuda")
    launches = (R.rope_kernel.launches, R.rope_kernel.backward_launches)
    rec = TA.TraceRecorder(fm)
    with fm, rec:
        if inverse:
            y = R.rope_kernel(x, positions, 1e6, inverse=True)
        else:
            y = L.apply_rope(x, positions, 1e6)
    assert is_fake(y) and y.device.type == "cuda"
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous()
    assert [op.name for op in rec.ops] == ["repro_torch.rope.default"]
    (op,) = rec.ops
    assert [t[0] for t in op.inputs] == [tuple(shape), tuple(pshape)]
    assert [t[0] for t in op.outputs] == [tuple(shape)]
    assert (R.rope_kernel.launches,
            R.rope_kernel.backward_launches) == launches


def test_fake_gradient_is_one_inverse_op():
    """Forward and backward through ``apply_rope`` on fake tensors with a
    gradient (CPU ones: a torch without CUDA cannot take gradients of fake
    CUDA tensors): the forward op and one inverse op, which saves nothing
    of x."""
    fm = FakeTensorMode()
    with fm:
        x = torch.empty(2, 16, 4, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        positions = torch.arange(16)
    rec = TA.TraceRecorder(fm)
    with fm, rec:
        y = L.apply_rope(x, positions, 1e6)
        assert type(y.grad_fn).__name__ == "_RopeBackward"
        (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert g.shape == x.shape and g.dtype == x.dtype
    ropes = [op for op in rec.ops if op.name.startswith("repro_torch.")]
    assert [op.name for op in ropes] == ["repro_torch.rope.default"] * 2


@pytest.mark.parametrize("inverse", [False, True])
def test_custom_op_passes_opcheck(inverse):
    """The op's schema, fake implementation and autograd registration, on
    CPU tensors (where it runs the plain version)."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 8, 3, 16, generator=gen)
    positions = torch.arange(8)
    torch.library.opcheck(torch.ops.repro_torch.rope.default,
                          (x, positions, 1e4, inverse))


BAD = [
    ("odd head dim", (2, 8, 4, 63), None, (8,), torch.int64, ValueError),
    ("head dim past 256", (2, 8, 4, 258), None, (8,), torch.int64,
     ValueError),
    ("positions of another length", (2, 8, 4, 64), None, (9,), torch.int64,
     ValueError),
    ("positions of another batch", (2, 8, 4, 64), None, (3, 8), torch.int64,
     ValueError),
    ("float positions", (2, 8, 4, 64), None, (8,), torch.float32, TypeError),
    ("three dims", (8, 4, 64), None, (8,), torch.int64, ValueError),
    ("strided head dim", (2, 8, 4, 64), (4096, 512, 128, 2), (8,),
     torch.int64, ValueError),
]


@pytest.mark.parametrize("name,shape,stride,pshape,pdtype,error", BAD,
                         ids=[b[0] for b in BAD])
def test_bad_inputs_raise_on_the_kernel_route(name, shape, stride, pshape,
                                              pdtype, error):
    """The kernel route checks as the card's launch does, on fake CUDA
    tensors too, before any op."""
    fm = FakeTensorMode()
    with fm:
        x = _fake_cuda(shape, torch.bfloat16, stride)
        positions = torch.empty(pshape, dtype=pdtype, device="cuda")
    with fm, pytest.raises(error):
        R.rope_kernel(x, positions)


def test_freqs_are_kept_once_and_never_fake():
    dev = torch.device("cpu")
    R._FREQS.pop((128, 1e6, dev), None)
    f = R._freqs(128, 1e6, dev)
    assert R._freqs(128, 1e6, dev) is f
    assert torch.equal(f, R.rope_freqs(128, 1e6))
    with FakeTensorMode():
        g = R._freqs(64, 5e5, dev)
    assert is_fake(g) and (64, 5e5, dev) not in R._FREQS
    R._FREQS.pop((128, 1e6, dev))
