"""Public entry points of the kernels, with the reference's call
contracts (``repro.kernels.ops``), so one test can hand the same arrays to
both packages.

The reference's wrappers flatten and pad every input to the TPU's tiles; the
port's kernels take any size, so these wrappers only make inputs contiguous
and reshape. CUDA tensors go through the kernels, CPU tensors through their
plain versions. Each takes every keyword the reference's takes: ``interpret``
(Pallas' interpret mode) and ``spike_matmul``'s ``block_m``/``block_k``/
``block_n`` (its TPU tiles) are accepted and ignored, since the device of
the tensors picks the route and the kernels choose their own tiles.
"""
from __future__ import annotations

import torch.nn.functional as F

from .flash_attention import flash_attention_kernel
from .lif import lif_step_kernel
from .spike_matmul import spike_matmul_kernel


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis, ``(lo, hi)``: the total is
    ``max((ceil(size / stride) - 1) * stride + k - size, 0)`` and the odd
    element goes after (``lo = total // 2``). PyTorch's ``padding=`` pads
    both sides alike, which shifts the window wherever the total is odd."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def lif_step(u, s_prev, current, *, threshold: float = 1.0,
             decay: float = 0.5, reset: str = "hard",
             interpret: bool | None = None):
    """Fused LIF update for state tensors of any (one) shape. ``interpret``
    is accepted and ignored."""
    return lif_step_kernel(u.contiguous(), s_prev.contiguous(),
                           current.contiguous(), threshold=threshold,
                           decay=decay, reset=reset)


def spike_matmul(spikes, w, *, interpret: bool | None = None,
                 block_m: int = 128, block_k: int = 128, block_n: int = 128):
    """``spikes [M, K] in {0, 1} @ w [K, N]`` in ``w.dtype``, float32 sums.
    ``interpret`` and the block sizes are accepted and ignored."""
    return spike_matmul_kernel(spikes.contiguous(), w.contiguous())


def im2col(spikes, w, stride: int = 1):
    """The operands ``spike_conv`` hands the matmul: patches ``[B Ho Wo,
    Cin kh kw]`` of NHWC ``spikes`` under SAME padding, and the HWIO weight
    ``w`` as ``[Cin kh kw, Cout]``. ``F.unfold`` on NCHW orders each patch's
    features ``[Cin, kh, kw]``, as the reference's
    ``conv_general_dilated_patches`` does."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = spikes.shape
    (ph0, ph1), (pw0, pw1) = same_pads(h, kh, stride), same_pads(wd, kw, stride)
    x = F.pad(spikes.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    patches = F.unfold(x, (kh, kw), stride=stride)      # [B, Cin kh kw, L]
    lhs = patches.transpose(1, 2).reshape(-1, cin * kh * kw)
    rhs = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return lhs.contiguous(), rhs.contiguous()


def spike_conv(spikes, w, stride: int = 1, *,
               interpret: bool | None = None):
    """NHWC spiking conv with SAME padding through im2col and the
    event-driven matmul: spikes ``[B, H, W, Cin]`` in {0, 1}, w
    ``[kh, kw, Cin, Cout]`` (HWIO) -> ``[B, ceil(H/s), ceil(W/s), Cout]``.
    ``interpret`` is accepted and ignored."""
    b, h, wd, _ = spikes.shape
    lhs, rhs = im2col(spikes, w, stride)
    return spike_matmul(lhs, rhs).reshape(b, -(-h // stride), -(-wd // stride),
                                          w.shape[3])


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    interpret: bool | None = None, block_q: int = 128,
                    block_k: int = 128):
    """``q [B, H, S, D]``, ``k``/``v [B, Hkv, S, D]`` -> ``[B, H, S, D]`` in
    ``q.dtype``, scaled by ``1/sqrt(D)`` of the true head dim. The kernel
    takes any ``S`` and ``D``, so nothing is padded; ``block_q`` and
    ``block_k`` keep the reference's contract, under which non-causal input
    whose ``S`` is not a multiple of ``max(block_q, block_k)`` raises.
    ``interpret`` is accepted and ignored."""
    if not causal and q.shape[2] % max(block_q, block_k):
        raise ValueError("non-causal attention requires S % block == 0")
    return flash_attention_kernel(q, k, v, causal=causal, window=window)
