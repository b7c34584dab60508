"""Spec-first parameter system (``repro.models.specs``).

Model code builds a nested dict of :class:`ParamSpec` (cheap: no tensors).
From that one description come

* ``materialize(specs, generator, device)``: the parameters, drawn from an
  explicit ``torch.Generator`` with the reference's initial distributions;
* ``shape_structs(specs)``: the same tree as ``meta``-device tensors, the
  counterpart of the reference's ``jax.ShapeDtypeStruct`` tree (no memory);
* ``logical_axes(specs)``: the logical axis names of every leaf.

Every spec carries logical axis names ("embed", "mlp", "heads", "vocab",
"layers", ...). ``jax.random`` cannot be reproduced here, so the port draws
other numbers from the same distributions; tests carry weights across with
``lm.from_reference_params`` where they need the reference's numbers.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import numpy as np

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple
    dtype: Any = torch.float32
    axes: tuple = ()          # logical axis names; len(axes) == len(shape)
    init: str = "normal"      # normal | zeros | ones | uniform_scaled
    scale: float | None = None  # stddev override; default fan-in scaled

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {self.shape}")


def param(shape, axes, dtype=torch.float32, init="normal",
          scale=None) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, tuple(axes), init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def check_tree(spec_tree, tree, path=()):
    """Raise ``ValueError`` unless ``tree`` (nested dicts of arrays) has
    exactly the leaves of ``spec_tree``, each of its spec's shape."""
    where = ".".join(path) or "params"
    if not isinstance(tree, Mapping):
        raise ValueError(f"{where}: expected a dict, got {type(tree)}")
    missing = sorted(set(spec_tree) - set(tree))
    surplus = sorted(set(tree) - set(spec_tree))
    if missing or surplus:
        raise ValueError(f"{where}: missing leaves {missing}, surplus leaves "
                         f"{surplus}")
    for k, v in spec_tree.items():
        if is_spec(v):
            shape = tuple(np.shape(tree[k]))
            if shape != v.shape:
                raise ValueError(f"{where}.{k}: shape {shape}, expected "
                                 f"{v.shape}")
        else:
            check_tree(v, tree[k], path + (k,))


def load_reference(specs, params, device=None):
    """The reference's parameters (nested dicts of numpy arrays under its
    pytree paths), checked against ``specs`` by :func:`check_tree`, as
    tensors on ``device`` (``None``: the card), each in its spec's
    dtype."""
    dev = resolve_device(device)
    check_tree(specs, params)

    def load(spec_tree, tree):
        return {k: (torch.tensor(np.asarray(tree[k], np.float32))
                    .to(device=dev, dtype=v.dtype) if is_spec(v)
                    else load(v, tree[k]))
                for k, v in spec_tree.items()}

    return load(specs, params)


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict (a spec or a tensor), keeping
    the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, path=()):
    """``[(path, leaf)]`` in sorted key order at every level, the order in
    which ``jax.tree_util`` flattens a dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def shape_structs(specs):
    """The spec tree as tensors on the ``meta`` device: shapes and dtypes, no
    memory (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def logical_axes(specs):
    return tree_map(lambda s: s.axes, specs)


def n_params(specs) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for _, s in tree_leaves(specs)))


def init_std(s: ParamSpec) -> float:
    """The standard deviation of a ``normal`` leaf: ``scale`` if given, else
    ``1/sqrt(fan_in)`` with the fan-in the first axis that is not
    ``layers`` (stacked layers keep their per-layer fan-in)."""
    if s.scale is not None:
        return float(s.scale)
    fan_axes = [d for d, ax in zip(s.shape, s.axes) if ax != "layers"]
    fan_in = fan_axes[0] if fan_axes else 1
    return 1.0 / math.sqrt(max(fan_in, 1))


# the most elements one float32 draw may hold (1 GiB): a larger leaf is drawn
# in chunks of whole rows along its leading axes
MAX_DRAW = 2 ** 28


def _draw_blocks(shape, max_draw: int):
    """``(rows, block)``: the leaf seen as ``[rows, *block]``, where
    ``block`` is the longest trailing part of ``shape`` of at most
    ``max_draw`` elements (the last axis alone if none is that small)."""
    k = len(shape) - 1 if shape else 0
    while k > 0 and math.prod(shape[k - 1:]) <= max_draw:
        k -= 1
    return math.prod(shape[:k]), tuple(shape[k:])


def _init_one(s: ParamSpec, generator: torch.Generator | None, device):
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if generator is None:
        raise ValueError(f"init {s.init!r} draws numbers: pass a generator")
    if s.init not in ("normal", "uniform_scaled"):
        raise ValueError(f"unknown init {s.init}")
    gen_dev = generator.device
    rows, block = _draw_blocks(s.shape, MAX_DRAW)
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    flat = out.view(rows, *block)
    step = max(1, MAX_DRAW // max(math.prod(block), 1))
    for r0 in range(0, rows, step):
        shape = (min(step, rows - r0),) + block
        if s.init == "normal":
            x = torch.randn(shape, generator=generator, device=gen_dev)
            x.mul_(init_std(s))
        else:
            lim = s.scale if s.scale is not None else 0.05
            x = torch.rand(shape, generator=generator, device=gen_dev)
            x.mul_(2 * lim).sub_(lim)
        flat[r0:r0 + shape[0]].copy_(x)
    return out


def materialize(specs, generator: torch.Generator | None = None,
                device=None):
    """Real parameters for ``specs`` on ``device`` (``None``: the card).
    Float32 draws come from ``generator`` on its own device, leaf by leaf in
    sorted path order, and are cast to each leaf's dtype as they are copied
    in; ``zeros`` and ``ones`` leaves draw nothing (a cache needs no
    generator). A leaf of more than ``MAX_DRAW`` elements is drawn in
    chunks, each of as many whole rows along its leading axes as fit in
    ``MAX_DRAW`` elements, in row order, so no float32 temporary exceeds
    ``MAX_DRAW`` elements (a leaf of at most ``MAX_DRAW`` is one draw)."""
    dev = resolve_device(device)
    out: dict = {}
    for path, s in tree_leaves(specs):
        if not path:
            return _init_one(s, generator, dev)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_one(s, generator, dev)
    return out


def cast_pytree(tree, dtype):
    """Every floating-point tensor of ``tree`` cast to ``dtype``."""
    def _c(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(_c, tree)
