"""Optimizers with the reference's update rule (``repro.train.optim``).

``adamw_update``: decoupled weight decay on matrices only, bias correction,
global-norm gradient clipping, and ``b2=0.95`` by default::

    m = b1 m + (1 - b1) g
    v = b2 v + (1 - b2) g²
    p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)     c_i = 1 - b_i^step

The moments are stored in float32 (default), bfloat16, or **int8
channel-quantized** (``state_dtype="int8"``): codes of the parameter's shape
with per-channel absmax scales over the last axis, ``v`` quantized as
``sqrt(v)`` and dequantized by squaring, as in the reference.

State is a nested dict ``{"step", "m", "v"}`` mirroring the parameters, as
the reference's ``adamw_init`` builds it. The reference donates params and
state to a new copy each step; the port updates every leaf **in place** and
returns the same trees (at 1.9 B parameters a second set of float32 moments
would cost 15 GB). ``step`` is a 0-dim int32 tensor on the CPU: the bias
corrections are host floats computed in float32, as the reference computes
them. The :class:`AdamW` class (a fixed list of float32 parameters, used by
the SNN trainer, PPO and the policy baseline) shares the bias corrections and
the parameter step; its moment update keeps its own rounding order.

DTensor leaves (a model on a mesh): each moment carries its parameter's
placements, and the update, elementwise, runs on each rank's local shards
of parameter, gradient and moments. What is not elementwise reduces over
the whole tensor: the global norm (DTensor sums), and an int8 moment's
per-channel absmax, all-reduced over the mesh axes that shard the last
axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from ..device import resolve_device
from ..obs import profile_range
from ..models.specs import (ParamSpec, check_tree, is_spec, tree_leaves,
                             tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0          # global-norm clip; 0 disables
    state_dtype: str = "fp32"       # fp32 | bf16 | int8


# ---- moment storage ------------------------------------------------------------

def _q8(x, sqrt_domain: bool = False, groups=()):
    """Per-channel (last axis) absmax int8. Returns ``(codes, scale)``.
    ``x`` may be a shard of the channels: its absmax is all-reduced over
    ``groups``."""
    if sqrt_domain:
        x = torch.sqrt(torch.clamp(x, min=0.0))
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    scale = amax / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale.float()


def _dq8(codes, scale, sqrt_domain: bool = False):
    x = codes.float() * scale
    if sqrt_domain:
        x = torch.square(x)
    return x


def _scale_ones(p):
    """An int8 moment's scales of ``p``, ``[..., 1]``: ones, beside ``p``
    (a DTensor where ``p`` is one, replicated where ``p`` shards its last
    axis)."""
    if not isinstance(p, DTensor):
        return torch.ones(p.shape[:-1] + (1,) if p.dim() else (1,),
                          dtype=torch.float32, device=p.device)
    loc = p.to_local()
    pl = [Replicate() if q.is_shard(p.dim() - 1) else q
          for q in p.placements]
    return DTensor.from_local(
        torch.ones(loc.shape[:-1] + (1,), dtype=torch.float32,
                   device=loc.device), p.device_mesh, pl)


def _zeros_state(p, tag: str):
    if tag == "int8":
        return {"codes": torch.zeros_like(p, dtype=torch.int8),
                "scale": _scale_ones(p)}
    dt = torch.bfloat16 if tag == "bf16" else torch.float32
    return torch.zeros_like(p, dtype=dt)


def _read_state(s, tag: str, sqrt_domain: bool = False):
    if tag == "int8":
        return _dq8(s["codes"], s["scale"], sqrt_domain)
    return s.float()


def _write_state(s, val, tag: str, sqrt_domain: bool = False,
                 groups=()) -> None:
    """Store ``val`` (float32) into the moment ``s`` in place."""
    if tag == "int8":
        codes, scale = _q8(val, sqrt_domain, groups)
        s["codes"].copy_(codes)
        s["scale"].copy_(scale)
    else:
        s.copy_(val)


def at_path(tree, path):
    """The node of a nested dict at ``path`` (an int8 moment's node is its
    ``{"codes", "scale"}`` dict)."""
    for k in path:
        tree = tree[k]
    return tree


# ---- the functional API --------------------------------------------------------

def adamw_init(params, cfg: AdamWConfig):
    """Zero moments beside each parameter (on its device), step 0."""
    return {
        "step": torch.zeros((), dtype=torch.int32),
        "m": tree_map(lambda p: _zeros_state(p, cfg.state_dtype), params),
        "v": tree_map(lambda p: _zeros_state(p, cfg.state_dtype), params),
    }


def opt_state_specs(param_specs, cfg: AdamWConfig):
    """ParamSpec tree mirroring :func:`adamw_init`."""
    def moment(s: ParamSpec):
        if cfg.state_dtype == "int8":
            return {
                "codes": ParamSpec(s.shape, torch.int8, s.axes, "zeros"),
                "scale": ParamSpec(s.shape[:-1] + (1,) if s.shape else (1,),
                                   torch.float32,
                                   s.axes[:-1] + (None,) if s.axes
                                   else (None,), "zeros"),
            }
        dt = torch.bfloat16 if cfg.state_dtype == "bf16" else torch.float32
        return ParamSpec(s.shape, dt, s.axes, "zeros")

    def walk(tree):
        if is_spec(tree):
            return moment(tree)
        return {k: walk(v) for k, v in tree.items()}

    tm = walk(param_specs)
    return {"step": ParamSpec((), torch.int32, (), "zeros"), "m": tm,
            "v": tm}


def opt_state_from_reference(param_specs, state, cfg: AdamWConfig,
                             device=None):
    """The reference's AdamW state ``{"step", "m", "v"}`` of the parameters
    ``param_specs`` describes (numpy leaves under its pytree paths; an int8
    moment is ``{"codes", "scale"}``), as the port's: each moment leaf on
    ``device`` (``None``: the card) in the dtype :func:`opt_state_specs`
    gives it for ``cfg``, ``step`` a CPU int32 scalar. bfloat16 moments
    arrive as any float array holding bfloat16 values and are carried
    exactly. Raises on a missing or surplus leaf and on a wrong shape."""
    dev = resolve_device(device)
    specs = opt_state_specs(param_specs, cfg)
    check_tree(specs, state)

    def leaf(x, spec):
        a = (np.asarray(x, np.float32) if spec.dtype.is_floating_point
             else np.asarray(x))
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=spec.dtype)

    def load(spec_tree, tree):
        return {k: leaf(tree[k], v) if is_spec(v) else load(v, tree[k])
                for k, v in spec_tree.items()}

    moments = load({"m": specs["m"], "v": specs["v"]}, state)
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32), **moments}


def opt_state_to_reference(state):
    """The port's AdamW state as nested dicts of numpy arrays under the
    reference's pytree paths: float moments in float32 (numpy has no
    bfloat16; bfloat16 values are exact there), int8 codes as int8, the
    step as an int32 scalar."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return {"step": np.int32(int(state["step"])),
            "m": tree_map(host, state["m"]), "v": tree_map(host, state["v"])}


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in float32, leaves summed in
    sorted path order."""
    total = None
    for _, x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        if isinstance(sq, DTensor):             # a partial sum on a shard
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _bias_corrections(step: int, cfg: AdamWConfig):
    """``1 - b_i^step`` in float32 on the host, as the reference computes
    them on the device."""
    s = np.float32(step)
    return (float(np.float32(1.0) - np.float32(cfg.b1) ** s),
            float(np.float32(1.0) - np.float32(cfg.b2) ** s))


def _adam_moments(g32, m, v, cfg: AdamWConfig):
    """The new float32 moments from a float32 gradient."""
    m = cfg.b1 * m + (1 - cfg.b1) * g32
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    return m, v


def _adam_param(p32, m, v, c1: float, c2: float, lr: float, decay: bool,
                cfg: AdamWConfig):
    """The new float32 parameter from the new moments."""
    delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
    if cfg.weight_decay and decay:             # decay matrices only
        delta = delta + cfg.weight_decay * p32
    return p32 - lr * delta


# the most elements of a leaf updated at once: float32 temporaries of at
# most 256 MiB each
MAX_UPDATE = 1 << 26


def _row_slices(p) -> list:
    """Slices of whole rows along ``p``'s first axis, each of at most
    ``MAX_UPDATE`` elements (one row at least); a leaf of fewer than two
    axes, whose int8 moment has one scale, is one slice."""
    if p.dim() < 2 or p.numel() <= MAX_UPDATE:
        return [slice(None)]
    rows = max(1, MAX_UPDATE // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _rows(tree, sl):
    """Rows ``sl`` of a leaf; an int8 moment ``{"codes", "scale"}`` (one
    scale a row) is cut leaf by leaf."""
    if isinstance(tree, dict):
        return {k: t[sl] for k, t in tree.items()}
    return tree[sl]


def _local(t):
    """The local shard of a DTensor leaf (or int8 moment), or the tensor."""
    if isinstance(t, dict):
        return {k: _local(v) for k, v in t.items()}
    return t.to_local() if isinstance(t, DTensor) else t


def placed_like(g, p):
    """``g`` laid out as the parameter ``p`` (a DTensor gradient is a
    partial sum over the ranks that split the batch: this all-reduces it);
    a plain ``g`` as it is."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _channel_groups(p) -> list:
    """The process groups of the mesh axes that shard ``p``'s last axis."""
    if not isinstance(p, DTensor) or p.dim() == 0:
        return []
    return [p.device_mesh.get_group(i) for i, q in enumerate(p.placements)
            if q.is_shard(p.dim() - 1)]


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step, in place. Returns ``(params, state)``: the same
    trees, updated. The arithmetic is elementwise in float32; a large leaf
    is updated in slices of whole rows (``_row_slices``), which gives the
    same numbers with a slice's worth of temporaries. DTensor leaves update
    their local shards. Under ``torch.profiler`` the whole update, the
    clipping norm included, is the range ``repro_torch.optim.adamw``."""
    with profile_range("optim.adamw"):
        return _adamw_update(grads, state, params, cfg, lr_scale)


def _adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale):
    step = int(state["step"]) + 1
    state["step"].fill_(step)
    tag = cfg.state_dtype
    scale = None
    if cfg.grad_clip > 0:
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    c1, c2 = _bias_corrections(step, cfg)
    lr = cfg.lr * lr_scale
    for path, p in tree_leaves(params):
        g, m_s, v_s = (at_path(t, path) for t in (grads, state["m"],
                                                  state["v"]))
        groups = _channel_groups(p)
        decay = p.dim() >= 2
        p, g, m_s, v_s = (_local(t) for t in (p, placed_like(g, p), m_s,
                                              v_s))
        for sl in _row_slices(p):
            pi = _rows(p, sl)
            g32 = _rows(g, sl).float()
            if scale is not None:
                g32 = g32 * scale
            mi, vi = _rows(m_s, sl), _rows(v_s, sl)
            m, v = _adam_moments(g32, _read_state(mi, tag),
                                 _read_state(vi, tag, True), cfg)
            pi.copy_(_adam_param(pi.float(), m, v, c1, c2, lr, decay, cfg))
            _write_state(mi, m, tag, groups=groups)
            _write_state(vi, v, tag, True, groups)
    return params, state


@torch.no_grad()
def sgd_update(grads, params, lr: float):
    """``p - lr g`` in float32, cast back to each parameter's dtype; in
    place, returns ``params``."""
    for path, p in tree_leaves(params):
        p.copy_(p.float() - lr * at_path(grads, path).float())
    return params


class AdamW:
    """fp32 AdamW state for a fixed list of parameters, updated in place."""

    def __init__(self, params, cfg: AdamWConfig):
        self.params = list(params)
        self.cfg = cfg
        self.step = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads, lr_scale: float = 1.0) -> None:
        """One AdamW step with ``grads`` (one per parameter, in order)."""
        cfg = self.cfg
        self.step += 1
        grads = [g.float() for g in grads]
        if cfg.grad_clip > 0:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = [g * scale for g in grads]
        c1, c2 = _bias_corrections(self.step, cfg)
        lr = cfg.lr * lr_scale
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            # (1 - b2) g g, rounded after each product: this class's own
            # order, kept so that its results stay bit for bit; the
            # functional update squares first, as the reference does
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            p.copy_(_adam_param(p, m, v, c1, c2, lr, p.dim() >= 2, cfg))
