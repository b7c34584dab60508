"""Spiking layer primitives: conv / BN / pool / linear (``repro.snn.layers``).

The port computes in NCHW, PyTorch's own layout, where the reference
computes in NHWC: activations are ``[B, C, H, W]`` and conv weights
``[Cout, Cin, kh, kw]`` (OIHW). ``repro_torch.snn.models.from_reference_params``
turns the reference's HWIO weights into OIHW. Linear weights keep the
reference's ``[din, dout]``.

Padding is XLA's SAME, which is asymmetric where the total is odd
(:func:`repro_torch.kernels.ops.same_pads`): the odd element goes after.
Where both sides match, the conv takes it as ``padding=``; otherwise the
input is padded explicitly first (with ``-inf`` for ``max_pool``).

The convolutions are cuDNN's, as the reference's are XLA's: the reference
never routes its model's convs through the spike-matmul kernel. On the card
cuDNN runs float32 convolutions in TF32 unless told otherwise; the training
path wraps its forward and backward in :func:`fp32_convs`, which turns TF32
off for its scope only.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..kernels.ops import same_pads


@contextlib.contextmanager
def fp32_convs():
    """Scope in which cuDNN convolutions run in full float32 (no TF32), the
    reference's semantics; the previous setting is restored on exit."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _pads2d(x, kh: int, kw: int, stride: int):
    return same_pads(x.shape[2], kh, stride), same_pads(x.shape[3], kw, stride)


def conv2d(params, x, stride: int = 1):
    """NCHW conv, OIHW weights ``params["w"]``, SAME padding."""
    w = params["w"]
    (ph0, ph1), (pw0, pw1) = _pads2d(x, w.shape[2], w.shape[3], stride)
    if ph0 == ph1 and pw0 == pw1:
        return F.conv2d(x, w, stride=stride, padding=(ph0, pw0))
    return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, stride=stride)


def batch_norm(params, x, eps: float = 1e-5):
    """Training-mode BN over (B, H, W) with the population variance:
    per-timestep statistics (tdBN-lite)."""
    mean = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), unbiased=False, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * params["scale"].view(1, -1, 1, 1) + \
        params["bias"].view(1, -1, 1, 1)


def max_pool(x, k: int = 2, stride: int = 2):
    """NCHW max pool with SAME padding (padded with ``-inf``)."""
    (ph0, ph1), (pw0, pw1) = _pads2d(x, k, k, stride)
    if ph0 or ph1 or pw0 or pw1:
        x = F.pad(x, (pw0, pw1, ph0, ph1), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def avg_pool_global(x):
    return x.mean(dim=(2, 3))


def linear(params, x):
    return x @ params["w"] + params["b"]
