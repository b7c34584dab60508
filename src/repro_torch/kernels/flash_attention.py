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
kernel. Given an ``lse`` tensor (``[B, H, S]`` float32), the forward also
writes each row's log-sum-exp, ``m + log(max(l, 1e-30))`` in natural log,
which is all its backward needs besides ``q, k, v, out``.

The backward (``flash_attention_backward_kernel``) computes the
reference's ``_flash_bwd`` (``repro/models/layers.py``, the custom VJP of
``_flash``) from ``q, k, v, out, dout, lse``: ``delta = rowsum(dout * out)``,
``p = exp(scale q k^T - lse)`` recomputed under the forward's mask, then
``dv = p^T dout``, ``ds = p (dout v^T - delta) scale``, ``dq = ds k``,
``dk = ds^T q``, with ``dk``/``dv`` summed over the ``H / Hkv`` query heads
of each kv head (the VJP of the reference's repeated heads). It launches
three kernels (the ``delta`` pre-pass, ``dK``/``dV`` and ``dQ``), each
deterministic; ``flash_attention_backward_kernel.launches`` counts calls,
``flash_attention_backward_kernel.tensor_core_launches`` those on the
tensor cores and ``flash_attention_backward_kernel.wgmma_launches`` those
on the wgmma kernels. All-bfloat16 inputs run on the tensor cores at every
head dim up to 256 (bf16 products with float32 sums, P and dS rounded to
bf16 as operands): up to D 128 on Hopper's wgmma with TMA loads and
warp-specialised warpgroups, where TMA can read q, k, v and dout (D a
multiple of 8, pointers and strides on 16 bytes), and on the mma.sync
kernels otherwise; past D 128 the wide kernels, eight warps with one
accumulator each. Any other mix runs on float32 copies on CUDA cores (see
the source note). The library picks the route before it launches and
reports it; none is taken after a failure.

Fake tensors (``torch._subclasses.fake_tensor``) of the card launch nothing
and count nothing: each wrapper checks them as it would real ones and calls
its custom op, ``torch.ops.repro_torch.flash_attention`` or
``flash_attention_backward``, whose fake implementation only stands for the
outputs it writes. A dispatch mode, such as the op-trace recorder of
``core/trace_analysis.py``, sees the call as one op with its shapes. A fake
tensor takes this route on any device: a torch built without CUDA cannot
take gradients of fake CUDA tensors (autograd asks CUDA for a device guard
and the process aborts), so the dry run there traces fake CPU tensors. Real
CPU tensors always take the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import is_fake

from . import FLOATS, _build, working_dtype

KERNEL = "flash_attention"
NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's routes as the library reports them: 0 float32 CUDA cores,
# 1 bf16 mma.sync up to D 128, 2 bf16 wgmma up to D 128, 3 bf16 past D 128
_TENSOR_CORE_ROUTES = (1, 2, 3)
_WGMMA_ROUTE = 2


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


def _check_lse(q, lse):
    b, h, s, _ = q.shape
    if lse is not None and (tuple(lse.shape) != (b, h, s)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError("flash_attention: lse must be a contiguous float32 "
                         f"[B, H, S] = {(b, h, s)} tensor on q's device")


def _scores(q, k, causal, window):
    """Dense float32 scores ``scale q k^T`` of ``q [B, H, S, D]`` against
    ``k`` repeated to ``H`` heads, masked with ``-1e30``."""
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return logits.masked_fill_(~mask, NEG_INF)


def _repeat(t, rep):
    return t if rep == 1 else t.repeat_interleave(rep, dim=1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          out: torch.Tensor | None = None,
                          lse: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: dense float32 scores, masked with ``-1e30``, a float32
    softmax and product (``repro.kernels.ref.attention_ref``). Writes into
    ``out`` when given and returns the result; writes each row's
    log-sum-exp into ``lse`` when given."""
    _check(q, k, v, window, out)
    _check_lse(q, lse)
    rep = q.shape[1] // k.shape[1]
    logits = _scores(q, _repeat(k, rep), causal, window)
    if lse is not None:
        lse.copy_(torch.logsumexp(logits, dim=-1))
    res = torch.matmul(torch.softmax(logits, dim=-1),
                       _repeat(v, rep).float()).to(q.dtype)
    if out is None:
        return res
    return out.copy_(res)


def _check_backward(q, k, v, out, dout, lse, window, grads):
    _check(q, k, v, window, out)
    _check_lse(q, lse)
    if lse is None:
        raise ValueError("flash_attention_backward: lse is required")
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_backward: dout {tuple(dout.shape)}"
                         f" must have q's shape {tuple(q.shape)}")
    for name, g, like in zip(("dq", "dk", "dv"), grads, (q, k, v)):
        if g is not None and (g.shape != like.shape or g.dtype != like.dtype
                              or g.device != like.device):
            raise ValueError(f"flash_attention_backward: {name} must match "
                             "the shape, dtype and device of its input")


def flash_attention_backward_plain(q, k, v, out, dout, lse, *,
                                   causal: bool = True,
                                   window: int | None = None,
                                   dq=None, dk=None, dv=None):
    """Plain version of the backward: dense float32, the reference's
    ``_flash_bwd`` over one q chunk that spans the sequence. Returns ``(dq,
    dk, dv)`` in the dtypes of ``q``, ``k``, ``v`` (written into ``dq``,
    ``dk``, ``dv`` when given)."""
    _check_backward(q, k, v, out, dout, lse, window, (dq, dk, dv))
    b, h, s, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    kf, vf = _repeat(k, rep).float(), _repeat(v, rep).float()
    do32 = dout.float()
    p = torch.exp(_scores(q, _repeat(k, rep), causal, window)
                  - lse[..., None])
    delta = (out.float() * do32).sum(-1)                 # rowsum(dO * O)
    ds = p * (torch.matmul(do32, vf.transpose(-1, -2)) - delta[..., None])
    ds = ds * scale
    res = (torch.matmul(ds, kf),
           torch.matmul(ds.transpose(-1, -2), q.float())
           .reshape(b, hkv, rep, s, d).sum(2),
           torch.matmul(p.transpose(-1, -2), do32)
           .reshape(b, hkv, rep, s, d).sum(2))
    outs = []
    for r, g, like in zip(res, (dq, dk, dv), (q, k, v)):
        r = r.to(like.dtype)
        outs.append(r if g is None else g.copy_(r))
    return tuple(outs)


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.repro_flash_attention
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        bwd = lib.repro_flash_attention_backward
        bwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p,
                                                    ctypes.POINTER(
                                                        ctypes.c_int)]
    return lib


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int | None = None,
                           out: torch.Tensor | None = None,
                           lse: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of ``q [B, H, S, D]`` over ``k``, ``v [B, Hkv, S, D]``, each
    float32, bfloat16 or float16, with a contiguous last dim (other strides
    are free); the result goes into ``out`` (``[B, H, S, D]`` in
    ``q.dtype``, any such strides) or a new contiguous tensor, in
    ``q.dtype`` as the reference returns it. All bfloat16 launches the
    tensor-core kernel; any other mix runs the float32 CUDA-core one on
    float32 copies (exact) and rounds its result once to ``q.dtype``.
    ``lse`` (contiguous ``[B, H, S]`` float32), when given, receives each
    row's log-sum-exp; without it the kernels write nothing more. CPU
    tensors take the plain version."""
    tensors = tuple(t for t in (q, k, v, out, lse) if t is not None)
    if any(is_fake(t) for t in tensors):
        _check(q, k, v, window, out)
        _check_lse(q, lse)
        if out is None:
            out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        torch.ops.repro_torch.flash_attention(q, k, v, out, lse, causal,
                                              window)
        return out
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     out=out, lse=lse)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention_kernel: q, k, v (and out) must be "
                         "on one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    _check(q, k, v, window, out)
    _check_lse(q, lse)
    if any(t.dtype not in FLOATS for t in (q, k, v)):
        raise TypeError("flash_attention_kernel: q, k and v must be "
                        "float32, bfloat16 or float16, got "
                        f"{[q.dtype, k.dtype, v.dtype]}")
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_kernel: head dim {d} > "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in tensors if t is not lse):
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
    rc = _lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), res.data_ptr(),
        None if lse is None else lse.data_ptr(), _strides(q), _strides(k),
        _strides(v), _strides(res), b, h, k.shape[1], s, d, scale,
        int(causal), 0 if window is None else int(window), _DTYPES[work],
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


def flash_attention_backward_kernel(q, k, v, out, dout, lse, *,
                                    causal: bool = True,
                                    window: int | None = None,
                                    dq=None, dk=None, dv=None):
    """Gradients ``(dq, dk, dv)`` of the attention ``out`` of ``q [B, H, S,
    D]`` over ``k``, ``v [B, Hkv, S, D]`` under the cotangent ``dout``, from
    the forward's ``lse`` (``[B, H, S]`` float32, contiguous). Strides as
    for the forward (a contiguous last dim); the results go into ``dq``,
    ``dk``, ``dv`` when given (any such strides) or new contiguous tensors,
    in the dtypes of ``q``, ``k``, ``v``. All bfloat16 runs the bf16
    tensor-core kernels (counted in ``tensor_core_launches`` too): up to D
    128 the wgmma ones (``wgmma_launches``) where D is a multiple of 8 and
    q, k, v and dout lie on 16 bytes with strides of whole 16 bytes, the
    mma.sync ones otherwise; past D 128 the wide ones. Any other mix runs
    the float32 kernels on float32 copies. A failed launch raises. CPU
    tensors take the plain version."""
    grads = (dq, dk, dv)
    tensors = tuple(t for t in (q, k, v, out, dout, lse) + grads
                    if t is not None)
    if any(is_fake(t) for t in tensors):
        _check_backward(q, k, v, out, dout, lse, window, grads)
        res = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
               if g is None else g for g, t in zip(grads, (q, k, v))]
        torch.ops.repro_torch.flash_attention_backward(
            q, k, v, out, dout, lse, *res, causal, window)
        return tuple(res)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_backward_plain(q, k, v, out, dout, lse,
                                              causal=causal, window=window,
                                              dq=dq, dk=dk, dv=dv)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention_backward_kernel: every tensor must "
                         "be on one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    _check_backward(q, k, v, out, dout, lse, window, grads)
    if any(t.dtype not in FLOATS for t in (q, k, v, out, dout)):
        raise TypeError("flash_attention_backward_kernel: q, k, v, out and "
                        "dout must be float32, bfloat16 or float16, got "
                        f"{[t.dtype for t in (q, k, v, out, dout)]}")
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_backward_kernel: head dim {d} > "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in (q, k, v, out, dout) + grads
           if t is not None):
        raise ValueError("flash_attention_backward_kernel: the head dim of "
                         "every tensor must be contiguous (stride 1)")
    if max(b, h) > 65535 or s >= 2 ** 31:
        raise ValueError(f"flash_attention_backward_kernel: shape "
                         f"{tuple(q.shape)} exceeds the launch grid")
    work = working_dtype(q, k, v, out, dout)
    like = (q, k, v)
    res = [torch.empty(t.shape, dtype=t.dtype, device=dev) if g is None
           else g for g, t in zip(grads, like)]
    if q.numel() == 0:
        return tuple(res)
    # the kernels' own outputs: the results, or working-dtype copies
    kout = [r if r.dtype == work else torch.empty(r.shape, dtype=work,
                                                  device=dev) for r in res]
    q, k, v, out, dout = (t.to(work) for t in (q, k, v, out, dout))
    # scratch: delta and lse log2 e, each [B, H, S rounded up to 128]
    delta = torch.empty(2 * b * h * (-(-s // 128) * 128),
                        dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    route = ctypes.c_int(-1)
    rc = _lib().repro_flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(t.data_ptr() for t in kout),
        *(_strides(t) for t in (q, k, v, out, dout, *kout)), b, h,
        k.shape[1], s, d, 1.0 / math.sqrt(d), int(causal),
        0 if window is None else int(window), _DTYPES[work], dev.index or 0,
        stream, ctypes.byref(route))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {rc}")
    flash_attention_backward_kernel.launches += 1
    if route.value in _TENSOR_CORE_ROUTES:
        flash_attention_backward_kernel.tensor_core_launches += 1
    if route.value == _WGMMA_ROUTE:
        flash_attention_backward_kernel.wgmma_launches += 1
    return tuple(r if r is kr else r.copy_(kr) for r, kr in zip(res, kout))


flash_attention_backward_kernel.launches = 0
flash_attention_backward_kernel.tensor_core_launches = 0
flash_attention_backward_kernel.wgmma_launches = 0


# The two kernels as custom ops, for fake tensors only (the wrappers above
# launch real ones directly): one op each in a trace, writing the outputs
# they are given.

@torch.library.custom_op("repro_torch::flash_attention",
                         mutates_args=("out", "lse"))
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor | None, causal: bool,
              window: int | None) -> None:
    flash_attention_kernel(q, k, v, causal=causal, window=window, out=out,
                           lse=lse)


@_flash_op.register_fake
def _(q, k, v, out, lse, causal, window):
    return None


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=("dq", "dk", "dv"))
def _flash_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor,
                       lse: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                       dv: torch.Tensor, causal: bool,
                       window: int | None) -> None:
    flash_attention_backward_kernel(q, k, v, out, dout, lse, causal=causal,
                                    window=window, dq=dq, dk=dk, dv=dv)


@_flash_backward_op.register_fake
def _(q, k, v, out, dout, lse, dq, dk, dv, causal, window):
    return None


def visible_pairs(s: int, causal: bool = True,
                  window: int | None = None) -> int:
    """The (query, key) pairs the mask leaves visible in one ``S x S``
    head: the work the attention must do, for its bound. Closed forms in
    integers, so a fake mode leaves them alone."""
    if window is None:
        return s * (s + 1) // 2 if causal else s * s
    m = min(window, s)
    if causal:                   # row i sees min(i + 1, window) keys
        return m * (m + 1) // 2 + (s - m) * m
    n = s - m                    # row i sees s - max(i - window + 1, 0)
    return m * s + n * (n + 1) // 2 + n * (window - 1)
