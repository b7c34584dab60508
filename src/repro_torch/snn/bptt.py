"""BPTT training step for spiking models (paper §4.1: FP / BP / WG engines).

Loss = cross-entropy on time-averaged logits (rate decoding) + an optional
spike-rate regularizer (keeps activity sparse, the event-driven efficiency
the near-memory hardware exploits). Gradients flow back through the Python
loop over time (BPTT) with surrogate spike derivatives, in one backward pass,
then the port's AdamW (``train.optim``) updates the parameters in place, in
``params.parameters()`` order (the reference's leaf order).

The forward and the backward run inside ``layers.fp32_convs``: cuDNN's
convolutions stay float32, as the reference's are. Nothing in a step waits
for the card: the metrics come back as 0-dim tensors on it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..train.optim import AdamW, AdamWConfig
from .layers import fp32_convs
from .models import SNNConfig, model_rollout


@dataclasses.dataclass(frozen=True)
class BPTTConfig:
    adam: AdamWConfig = AdamWConfig(lr=1e-3, grad_clip=1.0)
    rate_reg: float = 0.0


def loss_fn(params, cfg: SNNConfig, x, labels, rate_reg: float = 0.0):
    """``(loss, (ce, rate))`` for NHWC input ``x`` and integer ``labels``."""
    logits, rate = model_rollout(params, cfg, x)
    logp = F.log_softmax(logits.float(), dim=1)
    # mean of -logp[i, labels[i]]; nll_loss's backward writes each row's one
    # entry directly, where a gather's backward would scatter with atomics
    ce = F.nll_loss(logp, labels.long())
    return ce + rate_reg * rate, (ce, rate)


def loss_and_grads(params, cfg: SNNConfig, x, labels, rate_reg: float = 0.0):
    """``(loss, ce, rate, grads)``: one forward through the T loop and one
    backward; ``grads`` follow ``params.parameters()``."""
    with fp32_convs():
        loss, (ce, rate) = loss_fn(params, cfg, x, labels, rate_reg)
        grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.detach(), ce.detach(), rate.detach(), grads


def train_step(params, opt: AdamW, x, labels, cfg: SNNConfig,
               tcfg: BPTTConfig = BPTTConfig()):
    """One BPTT step. Updates ``params`` and ``opt`` in place and returns
    ``(params, opt, {"loss", "ce", "spike_rate"})``, the reference's
    contract."""
    loss, ce, rate, grads = loss_and_grads(params, cfg, x, labels,
                                           tcfg.rate_reg)
    opt.update(grads)
    return params, opt, {"loss": loss, "ce": ce, "spike_rate": rate}


def make_optimizer(params, tcfg: BPTTConfig = BPTTConfig()) -> AdamW:
    return AdamW(params.parameters(), tcfg.adam)
