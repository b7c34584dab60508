"""The models' loops: the port's counterpart of ``lax.scan``.

``scan(body, carry, n)`` runs ``carry, y = body(carry, i)`` for ``i`` in
``range(n)`` and returns ``(carry, [y_0, ..., y_{n-1}])``. On real tensors
and wherever no trace folds, it is exactly that Python loop.

Under a :class:`..core.trace_analysis.TraceRecorder` that folds loops (a
dry run's trace on fake tensors) a loop of four or more trips traces three
iterations: the first and the last as they are, and the second once for
the ``n - 2`` between them: the recorder counts every op of it, and of its
backward, ``n - 2`` times, as the reference's HLO walker multiplies a
``while`` body by its trip count; nested loops multiply. The first
iteration's carry comes from outside the loop (a plain zero state where
later steps carry DTensors, an embedding's layout), and the last one's
carry takes no gradient from a next step, so neither stands for the
others. The per-step outputs of the folded steps are ``y_1`` and ``n - 3``
copies of it detached from autograd, so that a ``cat`` or ``stack`` over
them has the unrolled loop's shapes and sends one gradient to the one
traced iteration. Bodies must therefore run the same ops, at the same
shapes and layouts, in every iteration but the first and the last.
"""
from __future__ import annotations

# the recorder that folds, while it records (set by TraceRecorder)
_folder = None


def recomputed(fn):
    """``fn`` as ``torch.utils.checkpoint`` should run it: under a
    recorder that folds, its recomputation in the backward is counted as
    its forward call was (the trip counts of the loops it ran in), whatever
    node's backward unpacks it; elsewhere ``fn`` itself."""
    folder = _folder
    return fn if folder is None else folder.recomputable(fn)


def scan(body, carry, n: int):
    """``(carry, ys)`` of ``carry, y = body(carry, i)`` over ``i < n``."""
    folder = _folder
    if folder is not None and n > 3:
        carry, first = body(carry, 0)
        carry, ys = folder.fold(lambda c: body(c, 1), carry, n - 2)
        carry, last = body(carry, n - 1)
        return carry, [first] + ys + [last]
    ys = []
    for i in range(n):
        carry, y = body(carry, i)
        ys.append(y)
    return carry, ys
