"""Flash attention forward: the CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by device.

For ``q [B, H, S, D]`` and ``k``, ``v [B, Hkv, S, D]`` (GQA: head ``h``
reads kv head ``h // (H / Hkv)``)::

    out = softmax(scale * q k^T + mask) v        (float32 softmax and sums)

with ``scale = 1/sqrt(D)`` of the true head dim, a causal mask, an
optional sliding window (key ``j`` visible to query ``i`` iff
``i - window < j``) and masked scores set to ``-1e30``, as in the
reference. The output is in ``q.dtype``.

The kernels (``csrc/flash_attention.cu``) replace the reference's Pallas
kernel ``repro/kernels/flash_attention.py::flash_attention_pallas``; its
source note gives the design and the bound. They take any ``S`` and any
``D`` up to 256 without padding, and read strided views whose head dim is
contiguous (so a BSHD tensor's ``transpose(1, 2)`` goes in without a copy).
A CUDA tensor launches a kernel (or raises); a CPU tensor takes
:func:`flash_attention_plain`.

The dtype picks the kernel, and each dtype has exactly one: bfloat16 runs
on the tensor cores (bf16 ``mma.sync`` products with float32 sums, P
rounded to bf16 for P.V as FA-2 does; within 1e-2 of the plain version),
float32 on CUDA cores in float32 (within 1e-5 of the plain version, which
bf16 or TF32 tensor cores cannot give; no served model runs float32
attention). float16 and mixed inputs run the float32 kernel on float32
copies, as the reference casts every input to float32 and returns
``q.dtype``. ``flash_attention_kernel.launches`` counts every launch,
``flash_attention_kernel.tensor_core_launches`` those of the tensor-core
kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import FLOATS, _build, working_dtype

KERNEL = "flash_attention"
NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, window, out):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: need q [B, H, S, D] and k, v "
                         f"[B, Hkv, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != s
            or k.shape[3] != d or hkv == 0 or h % hkv):
        raise ValueError("flash_attention: k and v must be [B, Hkv, S, D] "
                         f"with H a multiple of Hkv; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError("flash_attention: out must match q's shape, dtype "
                         "and device")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: dense float32 scores, masked with ``-1e30``, a float32
    softmax and product (``repro.kernels.ref.attention_ref``). Writes into
    ``out`` when given and returns the result."""
    _check(q, k, v, window, out)
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill_(~mask, NEG_INF)
    res = torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)
    if out is None:
        return res
    return out.copy_(res)


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_flash_attention
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int | None = None,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of ``q [B, H, S, D]`` over ``k``, ``v [B, Hkv, S, D]``, each
    float32, bfloat16 or float16, with a contiguous last dim (other strides
    are free); the result goes into ``out`` (``[B, H, S, D]`` in
    ``q.dtype``, any such strides) or a new contiguous tensor, in
    ``q.dtype`` as the reference returns it. All bfloat16 launches the
    tensor-core kernel; any other mix runs the float32 CUDA-core one on
    float32 copies (exact) and rounds its result once to ``q.dtype``. CPU
    tensors take the plain version."""
    tensors = (q, k, v) if out is None else (q, k, v, out)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     out=out)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention_kernel: q, k, v (and out) must be "
                         "on one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    _check(q, k, v, window, out)
    if any(t.dtype not in FLOATS for t in (q, k, v)):
        raise TypeError("flash_attention_kernel: q, k and v must be "
                        "float32, bfloat16 or float16, got "
                        f"{[q.dtype, k.dtype, v.dtype]}")
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_kernel: head dim {d} > "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("flash_attention_kernel: the head dim of q, k, v "
                         "and out must be contiguous (stride 1)")
    if max(b, h) > 65535 or s >= 2 ** 31:
        raise ValueError(f"flash_attention_kernel: shape {tuple(q.shape)} "
                         "exceeds the launch grid")
    work = working_dtype(q, k, v)
    if out is None:
        out = torch.empty(b, h, s, d, dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    # the kernel's own output: ``out`` itself, or a working-dtype copy
    res = out if work == q.dtype else torch.empty(b, h, s, d, dtype=work,
                                                  device=dev)
    q, k, v = (t.to(work) for t in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), res.data_ptr(),
                _strides(q), _strides(k), _strides(v), _strides(res), b, h,
                k.shape[1], s, d, scale, int(causal),
                0 if window is None else int(window), _DTYPES[work],
                dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention_kernel.launches += 1
    if work == torch.bfloat16:
        flash_attention_kernel.tensor_core_launches += 1
    return out if res is out else out.copy_(res)


flash_attention_kernel.launches = 0
flash_attention_kernel.tensor_core_launches = 0


def visible_pairs(s: int, causal: bool = True,
                  window: int | None = None) -> int:
    """The (query, key) pairs the mask leaves visible in one ``S x S``
    head: the work the attention must do, for its bound."""
    i = torch.arange(s, dtype=torch.int64)
    hi = i + 1 if causal else torch.full_like(i, s)
    lo = (i - window + 1).clamp(min=0) if window is not None else \
        torch.zeros_like(i)
    return int((hi - lo).clamp(min=0).sum().item())
