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
* ``n_dots``, and ``unknown_trip_whiles`` (always 0: an eager trace is
  unrolled);
* ``collectives``: ``by_kind`` (``count``, ``operand_bytes``,
  ``wire_bytes`` under the reference's kind names), totals and ``n_ops``,
  with the reference's ring model (``_collective_entry``) unchanged.

Every collective keeps the size and ranks of its process group, resolved
from the op's group name, so that ``core.gpu_adapter.traffic_from_trace``
can attribute it to the mesh dim it ran on.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
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
    inputs and outputs as ``(shape, dtype, itemsize)``, and ``attrs``: the
    collective's ``kind``, ``group_size``, ``group_ranks`` and
    ``group_name``; the flash kernel's ``causal`` and ``window``."""
    name: str
    inputs: list
    outputs: list
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def base(self) -> str:
        return self.name.split(".")[1] if "." in self.name else self.name


@dataclasses.dataclass
class Trace:
    """The ops of one traced step, and the most bytes of the rank's tensor
    storages alive at once."""
    ops: list
    peak_bytes: int = 0


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


class TraceRecorder(TorchDispatchMode):
    """Records the local ops of one rank into ``self.ops``
    (:class:`TraceOp`), and the bytes of the tensor storages they create.

    ``fake_mode``: the fake mode whose tensors the traced step runs on;
    the recorder runs each op it records in it (enter the recorder, not the
    mode). Ops on fake tensors of another mode (DTensor's sharding
    propagation) run unrecorded. ``None``: real tensors, run as they
    are.
    ``track``: tensors alive when recording starts (the step's arguments,
    local shards), counted in the live bytes until they die."""

    def __init__(self, fake_mode=None, track=()):
        super().__init__()
        self.fake_mode = fake_mode
        self.ops: list = []
        self.live = 0
        self.peak = 0
        self._seen: dict = {}
        for t in track:
            self._track(t)

    def trace(self) -> Trace:
        return Trace(self.ops, self.peak)

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
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    # -- dispatch -------------------------------------------------------
    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if self._foreign(ins) or _in_dtensor_bookkeeping():
            return func(*args, **kwargs)
        if self.fake_mode is None:
            out = func(*args, **kwargs)
        else:
            with self.fake_mode:
                out = func(*args, **kwargs)
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
                                [_desc(t) for t in outs], attrs))
        return out


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
    ``{"count", "operand_bytes", "wire_bytes"}``, ring model."""
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
        if "kind" in op.attrs:
            d = coll.setdefault(op.attrs["kind"], {"count": 0.0,
                                                   "operand_bytes": 0.0,
                                                   "wire_bytes": 0.0})
            for k, v in collective_entry(op).items():
                d[k] += v
        f = dot_flops(op)
        if f:
            n_dots += 1
        flops += f + flash_flops(op)
        bytes_ += op_bytes(op)
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
