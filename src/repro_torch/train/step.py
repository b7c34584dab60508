"""Train step: loss -> grad -> (optional compression) -> AdamW
(``repro.train.step``).

One factory serves every architecture family: the caller supplies
``loss_fn(params, batch) -> (loss, metrics)``. Features, as in the reference:

* global-norm clipping (in :func:`..optim.adamw_update`);
* optional **int8 gradient compression with error feedback**: each leaf is
  sent as per-channel int8 codes times a scale, and what that drops is added
  to the next step's gradient;
* microbatch gradient accumulation (``accum_steps``): the reference's
  ``lax.scan`` over microbatches is ``models.loop.scan`` summing float32
  gradients.

Gradients come from ``torch.autograd.grad`` over the parameter leaves, which
the step marks as requiring grad. The reference donates params and optimizer
state; the port updates both in place (and the error state) and returns the
same trees.

On a mesh (DTensor parameters, a sharded batch, the step inside
``sharding.rules.set_context``) each gradient is laid out as its parameter
(the all-reduce of the partial sums over the batch's ranks), the int8
compression takes each channel's absmax over the whole tensor (DTensor
reductions), and the metrics come back as plain full values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from torch.distributed.tensor import DTensor

from .optim import (AdamWConfig, adamw_init, adamw_update, at_path,
                    opt_state_specs, placed_like)
from ..models.loop import scan
from ..obs import profile_range
from ..models.specs import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adam: AdamWConfig = AdamWConfig(lr=3e-4, grad_clip=1.0)
    accum_steps: int = 1
    grad_compression: str = "none"      # none | int8_ef
    compression_block: int = 2048


# ---- int8 error-feedback gradient compression --------------------------------

def _compress_int8(g):
    scale = torch.amax(torch.abs(g), dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = codes.float() * scale
    return deq, g - deq                        # (transmitted value, residual)


@torch.no_grad()
def compress_grads(grads, error_state):
    """int8 EF compression leaf by leaf: returns ``(grads', error_state)``,
    the sent gradients (new tensors in each gradient's dtype) and the error
    state, updated in place with the residuals."""
    out = {}
    for path, g in tree_leaves(grads):
        e = at_path(error_state, path)
        deq, resid = _compress_int8(g.float() + e)
        e.copy_(resid)
        out[path] = deq.to(g.dtype)
    return _rebuild(grads, out), error_state


def error_state_init(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _rebuild(like, flat, path=()):
    """The nested dict of ``like``'s structure with leaves from ``flat``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in like.items()}
    return flat[path]


# ---- train step factory --------------------------------------------------------

def _full(t):
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def _value_and_grad(loss_fn, params, leaves, batch):
    with profile_range("train.forward"):
        loss, metrics = loss_fn(params, batch)
    with profile_range("train.backward"):
        grads = torch.autograd.grad(loss, leaves)
    grads = [placed_like(g, p) for g, p in zip(grads, leaves)]
    return _full(loss), {k: _full(v) for k, v in metrics.items()}, grads


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (loss, metrics: dict of scalars)``.
    Returns ``train_step(params, opt_state, batch, error_state=None) ->
    (params, opt_state, metrics[, error_state])``; ``batch`` is a dict of
    tensors with the batch first. Under ``torch.profiler`` the step is the
    range ``repro_torch.train.step``, each micro-batch's loss
    ``train.forward`` and its gradients ``train.backward``."""

    def train_step(params, opt_state, batch, error_state=None):
        with profile_range("train.step"):
            return _train_step(params, opt_state, batch, error_state)

    def _train_step(params, opt_state, batch, error_state):
        flat = tree_leaves(params)
        paths = [path for path, _ in flat]
        leaves = [p.requires_grad_() for _, p in flat]
        if tcfg.accum_steps > 1:
            n = tcfg.accum_steps
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]

            def micro(carry, i):
                mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                      for k, x in batch.items()}
                l, metrics, g = _value_and_grad(loss_fn, params, leaves, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                return carry, (l, metrics)

            _, outs = scan(micro, None, n)
            loss, seen = None, []
            for l, metrics in outs:
                loss = l if loss is None else loss + l
                seen.append(metrics)
            grads = [a / n for a in acc]
            loss = loss / n
            metrics = {k: torch.stack([m[k] for m in seen]).mean()
                       for k in seen[0]}
        else:
            loss, metrics, grads = _value_and_grad(loss_fn, params, leaves,
                                                   batch)
        grads = _rebuild(params, dict(zip(paths, grads)))

        if tcfg.grad_compression == "int8_ef":
            grads, error_state = compress_grads(grads, error_state)

        params, opt_state = adamw_update(grads, opt_state, params, tcfg.adam)
        metrics = dict(metrics)
        metrics["loss"] = loss
        out = (params, opt_state, metrics)
        if tcfg.grad_compression == "int8_ef":
            return out + (error_state,)
        return out

    return train_step


def init_optimizer(params, tcfg: TrainConfig):
    return adamw_init(params, tcfg.adam)


def optimizer_specs(param_specs, tcfg: TrainConfig):
    return opt_state_specs(param_specs, tcfg.adam)
