"""Weights drawn by the benchmark from ``--seed``, on the device, in the
type they are trained in.

The layout (leaf paths, shapes, dtypes, which leaves start at 0 or 1) is
the port's parameter description (``lm_specs``); the numbers are the
benchmark's own: one ``randn`` a drawn leaf from a ``torch.Generator`` on
the device, in sorted path order, scaled by the leaf's stated deviation or
``1 / sqrt(fan_in)``, the fan-in being the first axis that is not
``layers``. Replaying the same seed replays the same leaves, so the
reference redraws the initial weights itself instead of taking them from
the program.
"""
from __future__ import annotations

import math

import torch


def spec_leaves(specs, path=()):
    """``[(path, spec)]`` in sorted key order at every level."""
    if isinstance(specs, dict):
        out = []
        for k in sorted(specs):
            out.extend(spec_leaves(specs[k], path + (k,)))
        return out
    return [(path, specs)]


def _std(spec) -> float:
    if spec.scale is not None:
        return float(spec.scale)
    fan = [d for d, ax in zip(spec.shape, spec.axes) if ax != "layers"]
    return 1.0 / math.sqrt(max(fan[0] if fan else 1, 1))


def iter_weights(specs, seed: int, device):
    """``(path, tensor)`` for every leaf, drawn in order from one
    generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    for path, s in spec_leaves(specs):
        if s.init == "zeros":
            yield path, torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init == "ones":
            yield path, torch.ones(s.shape, dtype=s.dtype, device=device)
        elif s.init == "normal":
            t = torch.randn(s.shape, generator=gen, dtype=s.dtype,
                            device=device)
            yield path, t.mul_(_std(s))
        elif s.init == "uniform_scaled":
            lim = s.scale if s.scale is not None else 0.05
            t = torch.rand(s.shape, generator=gen, dtype=s.dtype,
                           device=device)
            yield path, t.mul_(2 * lim).sub_(lim)
        else:
            raise ValueError(f"{'.'.join(path)}: unknown init {s.init!r}")


def nest(flat):
    """Nested dicts from ``{path: tensor}``."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def draw(specs, seed: int, device):
    """All weights as nested dicts, each leaf in its own dtype."""
    return nest(dict(iter_weights(specs, seed, device)))


def stacked_paths(specs) -> set:
    """Paths of the leaves whose first axis stacks layers: the comparison
    reads them layer by layer."""
    return {path for path, s in spec_leaves(specs)
            if s.axes and s.axes[0] == "layers"}
