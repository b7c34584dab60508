"""Cost analysis of an op trace: the port's ``repro.core.hlo_analysis``.

The reference walks post-SPMD HLO text; the port has no HLO, so it walks an
**op trace**: every ATen op, functional collective and flash kernel call one
rank runs in a step, recorded by :class:`TraceRecorder` (a
``TorchDispatchMode``) while the step runs, typically once on fake tensors
over a fake process group (``launch/cells.py``), so nothing is allocated.

Counting is per device because the recorder sees **local** ops. A
dispatch mode runs before tensor subclasses, so it would see each DTensor op
at its global shapes and none of the collectives DTensor issues inside its
own dispatch. The recorder therefore declines every call that carries a
DTensor (returns ``NotImplemented``, as ``CommDebugMode`` does): DTensor
then runs, redistributes its operands with functional collectives and calls
the op on the local shards, and the recorder sees those calls.

On fake tensors the recorder stands in front of their fake mode: it runs
each op it records inside that mode, and the mode itself is not entered
around the step. DTensor's sharding propagation runs every op once more at
its global shapes on fake tensors (of the step's own fake mode), and sizes
strided shards with small host tensors whose values it reads: every op
called from within DTensor's ``sharding_prop.py`` or its
``local_shard_size_and_offset`` runs as it is, unrecorded, as do ops on
fake tensors of another fake mode.

:func:`analyze_trace` returns the reference's dict, key for key:

* ``flops``: 2·|out|·|contracted| over every ``mm``/``bmm``/``addmm``/
  ``baddbmm`` (``einsum`` and ``matmul`` lower to these), plus the flash
  kernels, one op each: 4·D FLOPs per visible (query, key) pair and head
  forward, 10·D backward (``kernels.flash_attention.visible_pairs``);
  elementwise work is not counted, as in the reference;
* ``bytes``: each op's operand plus output bytes (eager execution: one
  kernel, one HBM round trip per op), skipping views, allocations and
  other ops that move no data (the reference's ``_SKIP_BYTES_OPS``);
* ``n_dots``, and ``unknown_trip_whiles`` (always 0: every loop's trip
  count is known);
* ``collectives``: ``by_kind`` (``count``, ``operand_bytes``,
  ``wire_bytes`` under the reference's kind names), totals and ``n_ops``,
  with the reference's ring model (``_collective_entry``) unchanged.

Every collective keeps the size and ranks of its process group, resolved
from the op's group name, so that ``core.gpu_adapter.traffic_from_trace``
can attribute it to the mesh dim it ran on.

**Loops.** A recorder that folds (``fold=True``, on fake tensors) makes
``models.loop.scan`` trace the first and the last iteration of each loop
the models route through it, and one more that it counts for the ``n -
2`` between them (``TraceOp.count``; nested loops multiply), as the
reference's walker multiplies a ``while`` body by its trip count. Every
figure above is summed over ops times their count. The backward of the
traced iteration runs once too: each autograd node created inside a
folded iteration is known by its sequence number, and every op run while
autograd executes that node takes the iteration's count; a checkpointed
body's recomputation takes the count of the call it repeats
(``models.loop.recomputed``). The engine's accumulation of the gradients
that every iteration sends to one tensor made outside the loop (a layer's
slice of a stacked parameter, a chunk's slice of a sequence) runs once
where the unrolled step runs it ``n - 1`` times more; the recorder adds
those ``add`` ops (:meth:`TraceRecorder.fold`). Storages an iteration
leaves alive count ``n`` times until they die (saved activations,
per-step outputs; the carry too where autograd records it, since the
unrolled step keeps every iteration's), so the peak stays that of the
unrolled step. Without folding, or on real tensors, the loops run as
they are.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels.flash_attention import visible_pairs

# op name (without namespace and overload) -> the reference's kind: the
# functional collectives DTensor and the models issue, and the c10d ops of
# ``dist.all_reduce`` (MoE's load statistics) and of a point-to-point
# receive
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_C10D = {"allreduce_": "all-reduce", "recv_": "collective-permute"}

_DOTS = ("mm", "bmm", "addmm", "baddbmm")
_FLASH = {"flash_attention": 4.0, "flash_attention_backward": 10.0}

# ops that move no data: allocations, metadata, waits (views are found by
# their schema)
_SKIP_BYTES_OPS = {"empty", "empty_strided", "empty_like", "new_empty",
                   "new_empty_strided", "device", "lift_fresh",
                   "lift_fresh_copy", "wait_tensor", "_local_scalar_dense",
                   "is_same_size", "sym_size", "sym_stride", "sym_numel",
                   "sym_storage_offset", "detach", "set_", "resize_",
                   "record_stream", "send", "_wrap_tensor_autograd"}
# ops that write their output without reading their tensor inputs' data
_WRITE_ONLY_OPS = {"new_zeros", "new_ones", "new_full", "zeros_like",
                   "ones_like", "full_like", "fill_", "zero_"}


@dataclasses.dataclass
class TraceOp:
    """One recorded op: its name (``namespace.op.overload``), its tensor
    inputs and outputs as ``(shape, dtype, itemsize)``, ``attrs`` (the
    collective's ``kind``, ``group_size``, ``group_ranks`` and
    ``group_name``; the flash kernel's ``causal`` and ``window``), and
    ``count``: the times the unrolled step runs it (the trip counts of the
    folded loops it ran in)."""
    name: str
    inputs: list
    outputs: list
    attrs: dict = dataclasses.field(default_factory=dict)
    count: int = 1

    @property
    def base(self) -> str:
        return self.name.split(".")[1] if "." in self.name else self.name


@dataclasses.dataclass
class Trace:
    """The ops of one traced step, and the most bytes of the rank's tensor
    storages alive at once."""
    ops: list
    peak_bytes: int = 0

    @property
    def n_unrolled(self) -> int:
        """The ops the unrolled step runs (each op times its count)."""
        return sum(op.count for op in self.ops)


def _desc(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""),
            t.element_size())


def _nbytes(desc) -> float:
    shape, _, item = desc
    return float(math.prod(shape) * item)


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _group(name_or_pg):
    """``(size, ranks, name)`` of a process group given by name or as the
    object a ``c10d`` op receives."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    if isinstance(name_or_pg, str):
        pg = c10d._resolve_process_group(name_or_pg)
    else:
        pg = name_or_pg
        if not isinstance(pg, dist.ProcessGroup):
            pg = dist.ProcessGroup.unbox(pg)
    ranks = tuple(dist.get_process_group_ranks(pg))
    return len(ranks), ranks, pg.group_name


def _collective_attrs(func, args) -> dict | None:
    ns = func.namespace
    base = func._schema.name.split("::")[-1]
    if ns in ("_c10d_functional", "_c10d_functional_autograd"):
        kind = _FUNCTIONAL.get(base)
        if kind is None:
            return None
        size, ranks, name = _group(args[-1])
        if kind == "all-to-all":
            splits = args[2]
            # DTensor's permute_tensor: the whole input to one peer
            if splits and sum(1 for x in splits if x) == 1:
                kind = "collective-permute"
        return {"kind": kind, "group_size": size, "group_ranks": ranks,
                "group_name": name}
    if ns == "c10d" and base in _C10D:
        pg = next(a for a in args if not isinstance(a, (torch.Tensor, list,
                                                        int, float, bool))
                  and a is not None)
        size, ranks, name = _group(pg)
        return {"kind": _C10D[base], "group_size": size,
                "group_ranks": ranks, "group_name": name}
    return None


# DTensor's shard-size bookkeeping, which computes on small host tensors
_BOOKKEEPING = {"local_shard_size_and_offset"}


def _in_dtensor_bookkeeping() -> bool:
    """Called from within DTensor's sharding propagation or its shard-size
    bookkeeping."""
    f = sys._getframe(2)
    while f is not None:
        if (f.f_code.co_filename.endswith("sharding_prop.py")
                or f.f_code.co_name in _BOOKKEEPING):
            return True
        f = f.f_back
    return False


_STRIDED_SIZES: dict = {}


def _memoize_strided_shard_sizes(on: bool):
    """While a recorder records, remember DTensor's
    ``_StridedShard.local_shard_size_and_offset`` by its arguments: it
    sizes a strided shard (a view merging dims sharded over different
    mesh dims, as the batch over pod and data with a sequence or heads
    over model) by splitting an index tensor of the dim's length in host
    ops, each of which passes through the recorder, and the
    ``(2, 16, 16)`` mesh's training cells ask for the same sizes many
    times."""
    from torch.distributed.tensor import placement_types as pt
    cls = getattr(pt, "_StridedShard", None)
    fn = getattr(cls, "local_shard_size_and_offset", None)
    if fn is None:
        return
    orig = getattr(fn, "_uncached", None)
    if not on:
        if orig is not None:
            cls.local_shard_size_and_offset = orig
        return
    if orig is not None:
        return

    def cached(self, *args, **kwargs):
        try:
            key = (self, args, tuple(sorted(kwargs.items())))
            hash(key)
        except TypeError:            # symbolic sizes
            return fn(self, *args, **kwargs)
        hit = _STRIDED_SIZES.get(key)
        if hit is None:
            hit = _STRIDED_SIZES[key] = fn(self, *args, **kwargs)
        size, offset = hit
        return size, list(offset) if isinstance(offset, list) else offset
    cached._uncached = fn
    cls.local_shard_size_and_offset = cached


def _seq_peek() -> int:
    """The sequence number autograd gives the next node it creates on this
    thread."""
    return torch._C._autograd._get_sequence_nr()


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class TraceRecorder(TorchDispatchMode):
    """Records the local ops of one rank into ``self.ops``
    (:class:`TraceOp`), and the bytes of the tensor storages they create.

    ``fake_mode``: the fake mode whose tensors the traced step runs on;
    the recorder runs each op it records in it (enter the recorder, not the
    mode). Ops on fake tensors of another mode (DTensor's sharding
    propagation) run unrecorded. ``None``: real tensors, run as they
    are.
    ``track``: tensors alive when recording starts (the step's arguments,
    local shards), counted in the live bytes until they die.
    ``fold``: fold the loops of ``models.loop.scan`` (fake tensors
    only): one iteration recorded, counted by the trip count."""

    def __init__(self, fake_mode=None, track=(), fold: bool = False):
        super().__init__()
        self.fake_mode = fake_mode
        self.folds = bool(fold) and fake_mode is not None
        self.ops: list = []
        self.live = 0
        self.peak = 0
        self._seen: dict = {}
        self._mult = 1            # the trip counts of the folds entered
        self._ranges: list = []   # (first, end, count) of node numbers
        self._node_count: dict = {}
        self._task_base: dict = {}
        self._fresh: list = []    # storages made in each open fold
        self._alias_count: dict = {}  # node number -> its loop's context
        self._recompute: list = []  # (count, open folds) of a recompute
        self._dispatching = 0     # inside __torch_dispatch__
        self._paused = False
        self._prev_folder = None
        for t in track:
            self._track(t)

    def trace(self) -> Trace:
        return Trace(self.ops, self.peak)

    def __enter__(self):
        from ..models import loop
        self._prev_folder = loop._folder
        if self.folds:
            loop._folder = self
        _memoize_strided_shard_sizes(True)
        return super().__enter__()

    def __exit__(self, *exc):
        from ..models import loop
        loop._folder = self._prev_folder
        _memoize_strided_shard_sizes(False)
        return super().__exit__(*exc)

    # -- storages -------------------------------------------------------
    def _track(self, t):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor):
            return
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        if self._fresh:
            self._fresh[-1].add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    # -- folded loops ---------------------------------------------------
    def fold(self, body, carry, n: int):
        """``n`` steps of a ``models.loop.scan`` under this recorder:
        ``body(carry)`` once, its ops (and their backward) counted ``n``
        times. Returns the carry and the ``n`` per-step outputs.

        Where autograd records, every tensor that enters the iteration's
        graph from outside goes through an alias made at the loop's
        boundary, and every tensor that leaves it (the carry, the per-step
        outputs) through one made inside: aliases run no op in the
        backward, and they make every gradient slot take its arrivals from
        one side of the boundary only, so the engine's accumulations there
        count what the unrolled step's do, but for one: a tensor from
        outside takes the gradients of ``n`` iterations in the unrolled
        step, ``n - 1`` accumulations more than the one traced, which the
        recorder adds as ``add`` ops of the gradient's size in a backward
        run outside the loop (:meth:`_external_alias`)."""
        grad = torch.is_grad_enabled() and not _in_backward()
        outer = self._mult
        mode = None
        if grad:
            carry = self._alias_tree(carry)
            first = _seq_peek()
            mode = _AliasExternals(self, first, outer, n,
                                   {id(t) for t in _tensors(carry)})
        self._mult = outer * n
        fresh: set = set()
        self._fresh.append(fresh)
        peak0, self.peak = self.peak, self.live
        try:
            if mode is None:
                carry, y = body(carry)
            else:
                with mode:
                    carry, y = body(carry)
                carry, y = self._alias_tree(carry), self._alias_tree(y)
        finally:
            self._mult = outer
            self._fresh.pop()
            fold_peak = self.peak
            self.peak = max(peak0, fold_peak)
        if mode is not None:
            self._ranges.append((first, _seq_peek(), outer * n))
            self._node_count.clear()
        # what the iteration left alive, n times; a carry autograd does not
        # keep (no gradient to take) once
        outs = {id(t.untyped_storage()) for t in _leaves(y)}
        once = {id(t.untyped_storage()) for t in _leaves(
            [t for t in _tensors(carry) if not t.requires_grad])} - outs
        extra = 0
        for key in fresh:
            if key in self._seen and key not in once:
                extra += self._seen[key] * (n - 1)
                self._seen[key] *= n
        self.live += extra
        self.peak = max(self.peak, fold_peak + extra)
        if self._fresh:
            self._fresh[-1].update(fresh)
        self._paused = True
        try:
            rest = _detached(y)
        finally:
            self._paused = False
        return carry, [y] + [rest] * (n - 1)

    def _alias(self, t):
        """An alias of ``t`` (an autograd node that runs no op), made
        unrecorded."""
        self._paused = True
        try:
            return torch.ops.aten.alias(t)
        finally:
            self._paused = False

    def _alias_tree(self, tree):
        from torch.utils._pytree import tree_map
        return tree_map(lambda t: self._alias(t) if isinstance(
            t, torch.Tensor) and t.requires_grad else t, tree)

    def _outside(self, count: int) -> bool:
        """In a backward run where ``count`` (a loop's context) is: the
        engine accumulates what every iteration sends."""
        task = torch._C._current_graph_task_id()
        return self._task_base.setdefault(task, self._mult) <= count

    def _accumulations(self, grad, count: int):
        """``count`` gradient accumulations of ``grad``'s size."""
        if isinstance(grad, DTensor):
            grad = grad._local_tensor
        d = _desc(grad)
        self.ops.append(TraceOp("aten.add.Tensor", [d, d], [d], {}, count))

    def _external_alias(self, t, count: int, n: int):
        """The alias through which a loop (context ``count``, ``n`` trips)
        reads ``t``, made outside it: the unrolled step accumulates the
        gradients of ``n`` iterations into ``t``'s, ``n - 1`` adds more
        than the one iteration traced."""
        a = self._alias(t)
        self._alias_count[a.grad_fn._sequence_nr()] = count

        def pre(grad_outputs):
            g = grad_outputs[0]
            if g is not None and self._outside(count):
                self._accumulations(g, count * (n - 1))
        a.grad_fn.register_prehook(pre)
        return a

    def recomputable(self, fn):
        """``models.loop.recomputed``: ``fn`` whose recomputation (a call
        in a backward) counts as the call it repeats."""
        count = self._count()

        def run(*args, **kwargs):
            if not _in_backward():
                return fn(*args, **kwargs)
            self._recompute.append((count, self._mult))
            try:
                return fn(*args, **kwargs)
            finally:
                self._recompute.pop()
        return run

    def _count(self) -> int:
        """The count of an op dispatched now: the trip counts of the open
        folds and, in a backward, of the folded iteration that made the
        autograd node being run, or of the call a recomputation repeats (a
        backward started inside a fold, as a microbatch's, counts that
        fold's trips once)."""
        if not _in_backward():
            return self._mult
        if self._recompute:
            count, mult = self._recompute[-1]
            return count * (self._mult // mult)
        task = torch._C._current_graph_task_id()
        base = self._task_base.setdefault(task, self._mult)
        node = torch._C._current_autograd_node()
        m = base
        if node is not None and self._ranges:
            m = max(m, self._node_mult(node._sequence_nr()))
        return m * (self._mult // base)

    def _node_mult(self, seq: int) -> int:
        m = self._alias_count.get(seq) or self._node_count.get(seq)
        if m is None:
            m = max((c for lo, hi, c in self._ranges if lo <= seq < hi),
                    default=1)
            self._node_count[seq] = m
        return m

    # -- dispatch -------------------------------------------------------
    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        self._dispatching += 1
        try:
            return self._dispatch(func, args, kwargs or {})
        finally:
            self._dispatching -= 1

    def _dispatch(self, func, args, kwargs):
        ins = _tensors((args, kwargs))
        if self._foreign(ins) or _in_dtensor_bookkeeping():
            return func(*args, **kwargs)
        if self.fake_mode is None:
            out = func(*args, **kwargs)
        else:
            with self.fake_mode:
                out = func(*args, **kwargs)
        if self._paused:
            return out
        outs = _tensors(out)
        base = func._schema.name.split("::")[-1]
        attrs = _collective_attrs(func, args) or {}
        if func.namespace == "repro_torch" and base in _FLASH:
            # the kernels write their outputs into tensors they are given
            kw = dict(zip((a.name for a in func._schema.arguments), args))
            kw.update(kwargs)
            attrs = {"causal": bool(kw["causal"]), "window": kw["window"]}
            n_in = 3 if base == "flash_attention" else 6
            outs = [t for t in ins[n_in:]]
            ins = ins[:n_in]
        for t in outs:
            self._track(t)
        self.ops.append(TraceOp(str(func), [_desc(t) for t in ins],
                                [_desc(t) for t in outs], attrs,
                                self._count() if self.folds else 1))
        return out


class _AliasExternals(TorchFunctionMode):
    """Inside a folded iteration, each tensor made before it (a node
    numbered below ``first``, or a leaf) that requires grad is read
    through one alias (:meth:`TraceRecorder._external_alias`)."""

    def __init__(self, rec, first: int, count: int, n: int, internal):
        super().__init__()
        self.rec, self.first, self.count, self.n = rec, first, count, n
        self.internal = internal
        self.aliases: dict = {}

    def _sub(self, t):
        if (not isinstance(t, torch.Tensor) or not t.requires_grad
                or id(t) in self.internal):
            return t
        fn = t.grad_fn
        if fn is not None and fn._sequence_nr() >= self.first:
            return t
        hit = self.aliases.get(id(t))
        if hit is None:
            hit = self.aliases[id(t)] = (t, self.rec._external_alias(
                t, self.count, self.n))
            self.internal.add(id(hit[1]))
        return hit[1]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # the recorder's own calls, below autograd (torch 2.11 routes the
        # calls a dispatch mode makes through the torch-function modes),
        # and ATen ops are left alone; autograd's entries take the tensors
        # to differentiate as they are
        if (self.rec._dispatching
                or isinstance(func, (torch._ops.OpOverload,
                                     torch._ops.OpOverloadPacket))
                or func in _AUTOGRAD_ENTRIES or not torch.is_grad_enabled()
                or _in_backward()):
            return func(*args, **kwargs)
        from torch.utils._pytree import tree_map
        args, kwargs = tree_map(self._sub, (args, kwargs))
        return func(*args, **kwargs)


_AUTOGRAD_ENTRIES = {torch.autograd.grad, torch.autograd.backward,
                     torch.Tensor.backward}


def _leaves(tree) -> list:
    """The local tensors of a pytree (a DTensor's shard)."""
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def _detached(tree):
    """``tree`` with every tensor that requires grad detached."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                    and t.requires_grad else t, tree)


# ---------------------------------------------------------------- costs ----

@functools.lru_cache(maxsize=None)
def _is_view(name: str) -> bool:
    ns, rest = name.split(".", 1)
    op, _, overload = rest.partition(".")
    try:
        packet = getattr(getattr(torch.ops, ns), op)
        return getattr(packet, overload or "default").is_view
    except (AttributeError, RuntimeError):
        return False


def dot_flops(op: TraceOp) -> float:
    """2·|out|·|contracted| of a matrix product op (0 for other ops)."""
    if op.base not in _DOTS or not op.outputs:
        return 0.0
    lhs = op.inputs[1] if op.base in ("addmm", "baddbmm") else op.inputs[0]
    return 2.0 * math.prod(op.outputs[0][0]) * lhs[0][-1]


def flash_flops(op: TraceOp) -> float:
    """The flash kernels' FLOPs: ``4·D`` (forward) or ``10·D`` (backward)
    per visible (query, key) pair, per batch row and query head."""
    if op.base not in _FLASH or op.name.split(".")[0] != "repro_torch":
        return 0.0
    b, h, s, d = op.inputs[0][0]
    pairs = visible_pairs(s, op.attrs["causal"], op.attrs["window"])
    return _FLASH[op.base] * d * pairs * b * h


def collective_entry(op: TraceOp) -> dict:
    """The reference's ``_collective_entry`` on a recorded collective:
    ``{"count", "operand_bytes", "wire_bytes"}``, ring model, for one run
    of it (callers multiply by ``op.count``)."""
    kind = op.attrs["kind"]
    group = op.attrs["group_size"]
    g = max(group, 1)
    out_b = sum(_nbytes(d) for d in op.outputs)
    in_b = sum(_nbytes(d) for d in op.inputs)
    if kind == "all-gather":
        out_b = max(out_b, in_b * group)
        wire = (group - 1) / g * out_b
        operand = out_b / g
    elif kind == "reduce-scatter":
        operand = in_b
        wire = (group - 1) / g * operand
    elif kind == "all-reduce":
        operand = in_b or out_b
        wire = 2.0 * (group - 1) / g * operand
    elif kind == "all-to-all":
        operand = out_b
        wire = (group - 1) / g * operand
    else:                                    # collective-permute
        # what the rank sends is what it receives; DTensor's permute_tensor
        # sizes its splits in elements, so its output's shape is not that
        operand = in_b or out_b
        wire = operand
    return {"count": 1.0, "operand_bytes": operand, "wire_bytes": wire}


def op_bytes(op: TraceOp) -> float:
    """Operand plus output bytes of one op (0 for an op that moves no
    data); a collective counts its output, as in the reference."""
    if op.base in _SKIP_BYTES_OPS:
        return 0.0
    if "kind" in op.attrs:
        return sum(_nbytes(d) for d in op.outputs)
    if _is_view(op.name):
        return 0.0
    if op.base in _WRITE_ONLY_OPS:
        return sum(_nbytes(d) for d in op.outputs)
    return sum(_nbytes(d) for d in op.inputs + op.outputs)


def analyze_trace(trace) -> dict:
    """Per-device cost of a trace (a :class:`Trace` or a list of
    :class:`TraceOp`): the reference's ``analyze_hlo`` dict."""
    ops = trace.ops if isinstance(trace, Trace) else trace
    flops = bytes_ = 0.0
    n_dots = 0
    coll: dict = {}
    for op in ops:
        c = op.count
        if "kind" in op.attrs:
            d = coll.setdefault(op.attrs["kind"], {"count": 0.0,
                                                   "operand_bytes": 0.0,
                                                   "wire_bytes": 0.0})
            for k, v in collective_entry(op).items():
                d[k] += v * c
        f = dot_flops(op)
        if f:
            n_dots += c
        flops += (f + flash_flops(op)) * c
        bytes_ += op_bytes(op) * c
    return {
        "flops": flops,
        "bytes": bytes_,
        "n_dots": n_dots,
        "unknown_trip_whiles": 0,
        "collectives": {
            "by_kind": coll,
            "operand_bytes": sum(v["operand_bytes"] for v in coll.values()),
            "wire_bytes": sum(v["wire_bytes"] for v in coll.values()),
            "n_ops": sum(v["count"] for v in coll.values()),
        },
    }
