"""The comparison that decides ``correct`` for a training cell.

Both sides start from the same weights (drawn by the benchmark from the
seed) and take the same batches. The numbers compared:

* ``loss_gap``: over the checked steps, the largest
  ``|loss_program - loss_reference| / |loss_reference|``;
* ``grad_gap``: the first update's gradient as the optimizer took it
  (clipped), worked out on the program's side from its first moment after
  one step (``m_1 / (1 - b1)``); leaf by leaf (a stacked leaf layer by
  layer), the gap between the program's norm and the reference's over
  the larger of the reference's norm of that leaf and of the median leaf;
  the worst leaf;
* ``change_gap``: the same for the change of each leaf over the checked
  steps, ``|p_k - p_0|``, leaving out leaves whose first reference
  gradient is under a thousandth of the median leaf's (they move by
  round-off alone);
* ``nonfinite``: losses of the measured window that are not finite;
* ``dtype_faults``: leaves of the parameters or of the optimizer's moments
  not in the configuration's types.

A cell's file gives a limit to each number it compares; ``correct`` holds
where every one of them is at or under its limit.
"""
from __future__ import annotations

import statistics

import torch

ORDER = ("loss_gap", "grad_gap", "change_gap", "nonfinite", "dtype_faults")


def layer_slices(tree_leaves, stacked: set):
    """``{(path, layer): tensor}`` from ``[(path, tensor)]``: a stacked
    leaf cut along its first axis, any other whole (layer ``None``)."""
    out = {}
    for path, t in tree_leaves:
        if path in stacked:
            for li in range(t.shape[0]):
                out[(path, li)] = t[li]
        else:
            out[(path, None)] = t
    return out


@torch.no_grad()
def norms(slices: dict, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) * scale
            for k, t in slices.items()}


def gaps(prog: dict, ref: dict, keys=None) -> dict:
    """``|prog - ref| / max(ref, median ref)`` for each of ``keys``
    (default: every key of ``ref``)."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: _finite(abs(prog[k] - ref[k]) / max(ref[k], med))
            for k in keys}


def _finite(x: float) -> float:
    """``x``, or infinity where it is not a number."""
    return x if x == x else float("inf")


def moving_keys(ref_grad: dict) -> list:
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= 1e-3 * med]


def readings(prog: dict, ref: dict) -> dict:
    """The compared numbers from the program's and the reference's
    readings (``losses``, ``grad``, ``change``; the program's also
    ``nonfinite`` and ``dtype_faults``)."""
    loss_gap = max(_finite(abs(p - r) / abs(r))
                   for p, r in zip(prog["losses"], ref["losses"]))
    moving = moving_keys(ref["grad"])
    grad = gaps(prog["grad"], ref["grad"])
    change = gaps(prog["change"], ref["change"], moving)
    grad_at = max(grad, key=grad.get)
    change_at = max(change, key=change.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[grad_at],
            "change_gap": change[change_at],
            "nonfinite": prog["nonfinite"],
            "dtype_faults": prog["dtype_faults"],
            "_where": {"grad_gap": _name(grad_at),
                       "change_gap": _name(change_at)}}


def _name(key) -> str:
    if key is None:
        return "none"
    path, layer = key
    return ".".join(path) + ("" if layer is None else f"[{layer}]")


def judge(values: dict, limits: dict):
    """``(correct, checks)``: ``checks`` maps each number that ``limits``
    holds to its value and limit, in ``ORDER``. A number that is not
    finite fails."""
    checks, ok = {}, True
    for name in ORDER:
        if name not in limits:
            continue
        v, lim = values[name], limits[name]
        checks[name] = {"value": v, "limit": lim}
        ok &= bool(v == v and v <= lim)
    return ok, checks
