"""Rotary position embedding: the CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by device.

For ``x [B, S, H, D]`` (D even) and integer positions ``[S]`` or ``[B, S]``,
with ``freq = rope_freqs(D, theta)`` and float32 math::

    angle = float(pos) * freq                         ([..., S, D/2])
    y1 = x1 * cos(angle) - x2 * sin(angle)            (x1, x2: x's halves)
    y2 = x2 * cos(angle) + x1 * sin(angle)

rounded once to ``x.dtype``, as the reference's ``apply_rope``
(``repro/models/layers.py``) computes it. ``inverse=True`` rotates by
``-angle``, which is the map's backward: given the output's cotangent ``d``,
``dx1 = d1 cos + d2 sin`` and ``dx2 = d2 cos - d1 sin``, bit for bit what
autograd computes through the forward's torch ops.

The kernel (``csrc/rope.cu``) replaces no Pallas kernel (RoPE is plain JAX
in the reference); its source note gives the bound and the design. It is
bit-identical to :func:`rope_plain` on the card in both directions. It
takes float32, bfloat16 and float16, any even D up to 256, and strided views
whose last dim is contiguous (MLA's ``q_rope`` slice of q). The freqs are
computed by torch once per (D, theta, device) and kept.

A CUDA tensor launches the kernel (or raises on what it cannot take); a CPU
tensor takes :func:`rope_plain`. ``rope_kernel.launches`` counts forward
launches, ``rope_kernel.backward_launches`` inverse ones. Fake tensors
(``torch._subclasses.fake_tensor``) launch nothing and count nothing: they
go through the custom op ``torch.ops.repro_torch.rope``, whose fake
implementation only stands for the output, so that a dispatch mode (the
op-trace recorder of ``core/trace_analysis.py``) sees one op a call. As for
the flash kernels, a fake tensor takes this route on any device.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from . import FLOATS, _build

KERNEL = "rope"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_POSITIONS = (torch.int32, torch.int64)


def rope_freqs(d_head: int, theta: float = 1e4, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def rope_plain(x, positions, theta: float = 1e4, inverse: bool = False):
    """Plain version, x ``[..., S, H, D]`` (D even), positions ``[..., S]``
    int: the torch ops of the reference's ``apply_rope``, and with
    ``inverse`` the gradient autograd takes through them (its ``+ 0.0``
    stands for autograd's sum of the two halves' zero-filled slice
    gradients, which turns a -0 into +0)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # [D/2]
    angles = positions[..., None].float() * freqs      # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]              # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    if inverse:
        out = torch.cat([x1 * cos + x2 * sin, x2 * cos - x1 * sin],
                        dim=-1) + 0.0
    else:
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _check(x, positions):
    if x.dim() != 4:
        raise ValueError(f"rope: need x [B, S, H, D], got {tuple(x.shape)}")
    b, s, _, d = x.shape
    if d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"rope: head dim {d} must be even and at most "
                         f"{MAX_HEAD_DIM}")
    if x.dtype not in FLOATS:
        raise TypeError(f"rope: x must be float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if positions.dtype not in _POSITIONS:
        raise TypeError(f"rope: positions must be int32 or int64, got "
                        f"{positions.dtype}")
    shape = tuple(positions.shape)
    if shape not in ((s,), (b, s)):
        raise ValueError(f"rope: positions must be [S] or [B, S] with S = {s}"
                         f", B = {b}; got {shape}")
    if x.stride(3) != 1:
        raise ValueError("rope: the head dim of x must be contiguous (stride "
                         f"1), got strides {x.stride()}")


_FREQS: dict = {}


def _freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs(d, theta)`` on ``device``, computed once and kept."""
    key = (d, float(theta), device)
    f = _FREQS.get(key)
    if f is None:
        f = rope_freqs(d, theta, device)
        if not is_fake(f):
            _FREQS[key] = f
    return f


def _fn():
    fn = _build.load(KERNEL).repro_rope
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return fn


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def rope_kernel(x: torch.Tensor, positions: torch.Tensor,
                theta: float = 1e4, *, inverse: bool = False) -> torch.Tensor:
    """RoPE of ``x [B, S, H, D]`` (float32, bfloat16 or float16; any strides
    with a contiguous last dim) at ``positions`` (``[S]`` or ``[B, S]``,
    int32 or int64, on x's device); ``inverse`` rotates back (the
    backward). Returns a new contiguous tensor in ``x.dtype``. CPU tensors
    take the plain version."""
    if is_fake(x) or is_fake(positions):
        _check(x, positions)
        return torch.ops.repro_torch.rope(x, positions, float(theta),
                                          bool(inverse))
    if x.device.type == "cpu" and positions.device.type == "cpu":
        return rope_plain(x, positions, theta, inverse)
    dev = x.device
    if dev.type != "cuda" or positions.device != dev:
        raise ValueError("rope_kernel: x and positions must be on one CUDA "
                         f"device (or both on the CPU), got {x.device} and "
                         f"{positions.device}")
    _check(x, positions)
    b, s, h, d = x.shape
    if b > 65535 or s >= 2 ** 31 or b * h >= 2 ** 31:
        raise ValueError(f"rope_kernel: shape {tuple(x.shape)} exceeds the "
                         "launch grid")
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    if positions.dim() == 1:
        pos_sb, pos_ss = 0, positions.stride(0)
    else:
        pos_sb, pos_ss = positions.stride()
    freqs = _freqs(d, theta, dev)
    rc = _fn()(x.data_ptr(), y.data_ptr(), positions.data_ptr(),
               freqs.data_ptr(), b, s, h, d, _strides(x), _strides(y),
               pos_sb, pos_ss, int(positions.dtype == torch.int64),
               int(inverse), _DTYPES[x.dtype], dev.index or 0,
               torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"rope kernel launch failed: CUDA error {rc}")
    if inverse:
        rope_kernel.backward_launches += 1
    else:
        rope_kernel.launches += 1
    return y


rope_kernel.launches = 0
rope_kernel.backward_launches = 0


# The kernel as a custom op, for fake tensors only (the wrapper launches real
# ones directly): one op in a trace, with x and positions in and y out.

@torch.library.custom_op("repro_torch::rope", mutates_args=())
def _rope_op(x: torch.Tensor, positions: torch.Tensor, theta: float,
             inverse: bool) -> torch.Tensor:
    return rope_kernel(x, positions, theta, inverse=inverse)


@_rope_op.register_fake
def _(x, positions, theta, inverse):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)
