"""LIF neuron dynamics with surrogate-gradient spikes (BPTT-ready).

Forward (paper Fig 3 data flow)::

    U_t = λ·U_{t-1}·(1 - S_{t-1}) + I_t     (hard reset)
    U_t = λ·U_{t-1} - θ·S_{t-1} + I_t       (soft reset)
    S_t = H(U_t - θ)

The Heaviside spike is not differentiable; BPTT uses a surrogate derivative,
one of three standard choices (rectangular window as in STBP, sigmoid, atan)
behind :func:`spike`, a ``torch.autograd.Function`` with the reference's
``custom_vjp`` (``repro.snn.neurons``).

:func:`lif_step` is one ``torch.autograd.Function`` too. Its forward is the
fused LIF kernel (``repro_torch.kernels.lif``) on CUDA tensors and the
kernel's plain version on CPU tensors; both compute in float32 and round once
to the input dtype (the reference's module computes in the input dtype, which
is the same thing for the float32 training path). Its backward is the fused
LIF backward kernel of the same module on CUDA tensors (one launch) and its
plain version, torch operation by torch operation, on CPU tensors; like the
reference's autodiff, it differentiates through ``s_prev`` as well as ``u``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import lif as _lif
from ..kernels.lif import surrogate_grad

# the forward and backward of lif_step; module attributes so that a check
# can swap in the plain versions on the card and compare them bit for bit
_lif_forward = _lif.lif_step_kernel
_lif_backward = _lif.lif_backward_kernel


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    threshold: float = 1.0
    decay: float = 0.5            # membrane leak λ
    reset: str = "hard"           # hard | soft
    surrogate: str = "rect"       # rect | sigmoid | atan
    surrogate_scale: float = 2.0  # window width / steepness α


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u_minus_th, kind, alpha):
        ctx.save_for_backward(u_minus_th)
        ctx.kind, ctx.alpha = kind, alpha
        return (u_minus_th > 0).to(u_minus_th.dtype)

    @staticmethod
    def backward(ctx, g):
        (u_minus_th,) = ctx.saved_tensors
        return g * surrogate_grad(u_minus_th, ctx.kind, ctx.alpha), None, None


def spike(u_minus_th, kind: str = "rect", alpha: float = 2.0):
    """Heaviside spike ``(u_minus_th > 0)`` with a surrogate gradient."""
    return _Spike.apply(u_minus_th, kind, alpha)


class _LIFStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, s_prev, current, cfg: LIFConfig):
        if cfg.reset not in ("hard", "soft"):
            raise ValueError(cfg.reset)
        u, s_prev = u.contiguous(), s_prev.contiguous()
        u_new, s_new = _lif_forward(
            u, s_prev, current.contiguous(), threshold=cfg.threshold,
            decay=cfg.decay, reset=cfg.reset)
        ctx.save_for_backward(u, s_prev, u_new)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        return u_new, s_new

    @staticmethod
    def backward(ctx, g_u, g_s):
        u, s_prev, u_new = ctx.saved_tensors
        cfg = ctx.cfg
        need_u, need_s = ctx.needs_input_grad[:2]
        d_u, d_s, g = _lif_backward(
            None if g_u is None else g_u.contiguous(),
            None if g_s is None else g_s.contiguous(), u, s_prev, u_new,
            threshold=cfg.threshold, decay=cfg.decay, reset=cfg.reset,
            surrogate=cfg.surrogate, alpha=cfg.surrogate_scale,
            need_u=need_u, need_s=need_s)
        return d_u, d_s, g, None


def lif_step(u, s_prev, current, cfg: LIFConfig):
    """One LIF timestep. Returns ``(u_new, s_new)``."""
    return _LIFStep.apply(u, s_prev, current, cfg)


def lif_rollout(currents, cfg: LIFConfig):
    """Unroll LIF over time: currents ``[T, ...]`` -> spikes ``[T, ...]``."""
    u = torch.zeros_like(currents[0])
    s = torch.zeros_like(currents[0])
    spikes = []
    for i_t in currents:
        u, s = lif_step(u, s, i_t, cfg)
        spikes.append(s)
    return torch.stack(spikes)
