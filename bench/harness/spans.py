"""Device time by program span: each device operation of a traced window
(kernel, copy, fill) attributed to the innermost ``repro_torch.`` range of
the program that launched it, and to a pass.

The program opens its ranges (``repro_torch.obs.profile_range``) only
under the profiler; they are op-scope records on the host, on the
profiler's clock, with no copy on the device's timeline. The rules, in
order, for one device operation:

1. its host anchor: the host op it links to (CUPTI's external
   correlation), else the host op of its launch (the CUDA API call of the
   same correlation id), else the launch itself;
2. a program span other than ``train.*`` innermost at the anchor on the
   anchor's thread owns it. The pass is ``recompute`` where that span, or
   one around it, is ``model.layer`` or ``model.ce_chunk`` and opened
   while ``train.backward`` was open (on any thread: autograd runs the
   backward on a thread of its own); ``optimizer`` under ``optim.*``;
   ``forward`` otherwise;
3. an ``autograd::engine::evaluate_function: <Node>`` range innermost at
   the anchor: the operation belongs to the backward of the node's
   forward op, the latest-starting host op before the range with the
   node's ``(sequence_nr, forward thread)`` (every op carries the
   thread's peek of the counter; the op that makes the node is the last
   before it steps). The innermost program span around that forward op
   owns it, with pass ``backward``;
4. otherwise the innermost ``train.*`` span open on the step's thread at
   the anchor's time (the fallback).

``read(rows, window, steps)`` gives :class:`Split`; :data:`METRICS` the
device milliseconds a step the program's spans are read into. The rows
come from :func:`rows` (a ``torch.profiler.profile`` object) or, in tests,
are built by hand.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

PREFIX = "repro_torch."
EVAL = "autograd::engine::evaluate_function: "
RECOMPUTED = ("model.layer", "model.ce_chunk")
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
ANNOTATIONS = (PREFIX, "bench.")


@dataclasses.dataclass
class Row:
    """One profiler event: ``kind`` is ``op`` (a host op or range),
    ``launch`` (a CUDA API call) or ``device`` (a kernel, copy or fill on
    the card)."""
    kind: str
    name: str
    start: int
    end: int
    tid: int = 0
    seq: int = -1
    fwd_tid: int = 0
    corr: int = 0
    linked: int = 0


def _activity(e):
    f = getattr(e, "activity_type", None)
    try:
        return f() if f is not None else None
    except (RuntimeError, TypeError):
        return None


def row_kind(e) -> str | None:
    """``op``, ``launch``, ``device`` or None (a range's copy on the
    device). Where the event carries no activity type, a device event is
    told by its device and a launch by its name (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)."""
    act, name = _activity(e), e.name()
    if str(e.device_type()).endswith("CUDA"):
        if act == "gpu_user_annotation" or name.startswith(ANNOTATIONS):
            return None
        return "device"
    if (act or "").startswith("cuda_") or (
            act is None and LAUNCH.match(name)):
        return "launch"
    return "op"


def rows(prof) -> list:
    """The :class:`Row` of every event of a finished profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = row_kind(e)
        if kind is None:
            continue
        s = e.start_ns()
        out.append(Row(kind, e.name(), s, s + e.duration_ns(),
                       e.start_thread_id(), e.sequence_nr(),
                       e.fwd_thread_id(), e.correlation_id(),
                       e.linked_correlation_id()))
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class _Scope:
    name: str             # a program span without the prefix, or EVAL...
    start: int
    end: int
    tid: int
    seq: int = -1
    fwd_tid: int = 0
    parent: "_Scope | None" = None

    @property
    def program(self) -> bool:
        return not self.name.startswith(EVAL)


def _scopes(ops) -> dict:
    """Program spans and autograd's node ranges by thread, each sorted by
    start (outer first at a tie), each with the scope around it."""
    by_tid = defaultdict(list)
    for r in ops:
        if r.name.startswith(PREFIX):
            name = r.name[len(PREFIX):]
        elif r.name.startswith(EVAL):
            name = r.name
        else:
            continue
        by_tid[r.tid].append(_Scope(name, r.start, r.end, r.tid, r.seq,
                                    r.fwd_tid))
    for lst in by_tid.values():
        lst.sort(key=lambda s: (s.start, -s.end))
        stack = []
        for sc in lst:
            while stack and stack[-1].end <= sc.start:
                stack.pop()
            sc.parent = stack[-1] if stack else None
            stack.append(sc)
    return by_tid


def _innermost(scopes: dict, queries) -> dict:
    """``{qid: innermost scope holding time t on thread tid, or None}`` of
    ``queries`` ``[(tid, t, qid)]``."""
    out = {}
    by_tid = defaultdict(list)
    for tid, t, qid in queries:
        by_tid[tid].append((t, qid))
    for tid, qs in by_tid.items():
        ivs = scopes.get(tid, [])
        qs.sort(key=lambda q: q[0])
        stack, j = [], 0
        for t, qid in qs:
            while j < len(ivs) and ivs[j].start <= t:
                while stack and stack[-1].end <= ivs[j].start:
                    stack.pop()
                stack.append(ivs[j])
                j += 1
            while stack and stack[-1].end <= t:
                stack.pop()
            out[qid] = stack[-1] if stack else None
    return out


def _program(sc):
    """The innermost program span at or around scope ``sc``."""
    while sc is not None and not sc.program:
        sc = sc.parent
    return sc


def _chain(sc):
    while sc is not None:
        yield sc
        sc = sc.parent


@dataclasses.dataclass
class Owned:
    op: Row
    owner: str | None     # a span without the prefix; None: nothing holds it
    pass_: str            # forward | backward | recompute | optimizer | step
    rule: int             # 2, 3 or 4 (0: no span holds it)
    anchor: str = "op"    # op | launch (no host op linked) | none


def _train_pass(name: str) -> str:
    return {"train.forward": "forward",
            "train.backward": "backward"}.get(name, "step")


def attribute(rows_, window=None) -> list:
    """An :class:`Owned` for every device operation of ``rows_`` inside
    ``window`` (``(start, end)`` ns; None: all of them)."""
    ops = [r for r in rows_ if r.kind == "op"]
    launches = {r.corr: r for r in rows_ if r.kind == "launch" and r.corr}
    devs = [r for r in rows_ if r.kind == "device" and (
        window is None or (r.start >= window[0] and r.end <= window[1]))]
    by_corr = {r.corr: r for r in ops if r.corr}
    tidmap = {}
    for lr in launches.values():
        op = by_corr.get(lr.linked)
        if op is not None:
            tidmap.setdefault(lr.tid, op.tid)
    scopes = _scopes(ops)
    backward = [(s.start, s.end) for lst in scopes.values() for s in lst
                if s.name == "train.backward"]
    main = main_thread(rows_)

    anchors, how = {}, {}
    for i, d in enumerate(devs):
        op = by_corr.get(d.linked)
        lr = launches.get(d.corr) if op is None else None
        if lr is not None:
            op = by_corr.get(lr.linked)
        if op is not None:
            anchors[i] = (op.tid, op.start)
        elif lr is not None:
            anchors[i] = (tidmap.get(lr.tid, lr.tid), lr.start)
            how[i] = "launch"
    at = _innermost(scopes, [(tid, t, i) for i, (tid, t) in anchors.items()])

    fwd = defaultdict(list)
    for r in ops:
        if r.seq >= 0 and r.fwd_tid == 0 and not r.name.startswith(EVAL):
            fwd[(r.seq, r.tid)].append((r.start, r))
    for v in fwd.values():
        v.sort(key=lambda p: p[0])
    fwd_op = {}
    for sc in {id(s): s for s in at.values()
               if s is not None and not s.program}.values():
        cands = fwd.get((sc.seq, sc.fwd_tid), [])
        k = bisect.bisect_left(cands, sc.start, key=lambda p: p[0])
        if k:
            fwd_op[id(sc)] = cands[k - 1][1]
    fwd_at = _innermost(scopes, [(r.tid, r.start, key)
                                 for key, r in fwd_op.items()])
    main_at = _innermost(scopes, [(main, t, i)
                                  for i, (_, t) in anchors.items()])

    def in_backward(sc) -> bool:
        return any(s <= sc.start < e for s, e in backward)

    out = []
    for i, d in enumerate(devs):
        if i not in anchors:
            out.append(Owned(d, None, "step", 0, "none"))
            continue
        sc = at.get(i)
        if sc is not None and sc.program and not sc.name.startswith("train."):
            chain = list(_chain(sc))
            if any(c.name in RECOMPUTED and in_backward(c) for c in chain):
                p = "recompute"
            elif any(c.name.startswith("optim.") for c in chain):
                p = "optimizer"
            else:
                p = "forward"
            out.append(Owned(d, sc.name, p, 2, how.get(i, "op")))
            continue
        if sc is not None and not sc.program and id(sc) in fwd_op:
            own = _program(fwd_at.get(id(sc)))
            if own is not None:
                out.append(Owned(d, own.name, "backward",
                                 4 if own.name.startswith("train.") else 3,
                                 how.get(i, "op")))
                continue
        own = main_at.get(i)
        while own is not None and not own.name.startswith("train."):
            own = own.parent
        if own is not None:
            out.append(Owned(d, own.name, _train_pass(own.name), 4,
                             how.get(i, "op")))
        else:
            out.append(Owned(d, None, "step", 0, how.get(i, "op")))
    return out


# device ms a step of the program's spans; ``recompute_ms_per_step`` is
# every operation of pass ``recompute``
METRICS = {
    "optimizer_ms_per_step": "optim.adamw",
    "ce_ms_per_step": "model.ce",
    "norm_ms_per_step": "model.norm",
    "rope_ms_per_step": "model.rope",
    "swiglu_ms_per_step": "model.swiglu",
    "layer_slice_ms_per_step": "model.layer_params",
    "recompute_ms_per_step": None,
}


@dataclasses.dataclass
class Split:
    owned: list
    steps: int

    def ms(self, keep) -> float:
        """Device ms a step of the operations ``keep(Owned)`` accepts."""
        return sum(o.op.end - o.op.start for o in self.owned
                   if keep(o)) / 1e6 / self.steps

    def metrics(self) -> dict:
        """``{metric: ms a step}``, None where no operation was read."""
        out = {}
        for name, span in METRICS.items():
            if span is None:
                keep = lambda o: o.pass_ == "recompute"  # noqa: E731
            else:
                keep = lambda o, s=span: o.owner == s  # noqa: E731
            out[name] = (self.ms(keep) if any(map(keep, self.owned))
                         else None)
        return out

    def table(self) -> list:
        """``[(span, pass, ms a step, kernels a step)]``, longest first."""
        acc = defaultdict(lambda: [0, 0])
        for o in self.owned:
            a = acc[(o.owner or "(none)", o.pass_)]
            a[0] += o.op.end - o.op.start
            a[1] += is_kernel(o.op.name)
        rows_ = [(k[0], k[1], ns / 1e6 / self.steps, n / self.steps)
                 for k, (ns, n) in acc.items()]
        return sorted(rows_, key=lambda r: -r[2])

    def fallback_share(self) -> float:
        """The share of the operations' device time that only a
        ``train.*`` span, or nothing, owns."""
        total = self.ms(lambda o: True)
        return self.ms(lambda o: o.rule in (0, 4)) / total if total else 0.0

    def rules(self) -> dict:
        """Device ms a step by the rule that placed the operations."""
        return {r: self.ms(lambda o, r=r: o.rule == r)
                for r in sorted({o.rule for o in self.owned})}

    def parts(self, is_gemm, is_flash) -> dict:
        """The step's device time in disjoint parts: GEMMs and flash by
        kernel name first, then by owning span (the rest of a span's
        operations), ``train.*`` and unowned last; ms a step."""
        acc = defaultdict(float)
        for o in self.owned:
            n = o.op.name
            if is_gemm(n):
                key = "gemm (by name)"
            elif is_flash(n):
                key = "flash (by name)"
            elif o.owner is None or o.owner.startswith("train."):
                key = "fallback (train.* or none)"
            else:
                key = o.owner
            acc[key] += (o.op.end - o.op.start) / 1e6 / self.steps
        return dict(sorted(acc.items(), key=lambda kv: -kv[1]))

    def by_kernel(self, top: int = 10) -> list:
        """The ``top`` device operation names with the most time,
        ``[(name, ms a step, {owner: ms a step})]``."""
        acc = defaultdict(lambda: defaultdict(int))
        for o in self.owned:
            acc[o.op.name][o.owner or "(none)"] += o.op.end - o.op.start
        ranked = sorted(acc.items(), key=lambda kv: -sum(kv[1].values()))
        per = 1e6 * self.steps
        return [(name, sum(d.values()) / per,
                 {k: v / per for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])})
                for name, d in ranked[:top]]


def read(rows_, window=None, steps: int = 1) -> Split:
    return Split(attribute(rows_, window), steps)


def main_thread(rows_) -> int:
    """The thread that ran the most ``train.step`` spans."""
    tids = defaultdict(int)
    for r in rows_:
        if r.kind == "op" and r.name == PREFIX + "train.step":
            tids[r.tid] += 1
    return max(tids, key=tids.get) if tids else 0


def span_at(rows_, tid: int, times) -> list:
    """The innermost program span (without the prefix) open on thread
    ``tid`` at each host time of ``times``; ``outside`` where none is."""
    scopes = _scopes([r for r in rows_ if r.kind == "op" and r.tid == tid
                      and r.name.startswith(PREFIX)])
    at = _innermost(scopes, [(tid, t, i) for i, t in enumerate(times)])
    return [at[i].name if at.get(i) else "outside"
            for i in range(len(times))]


def host_ms(rows_, name: str, steps: int, window=None) -> float:
    """Host ms a step inside the program span ``name``."""
    tot = sum(r.end - r.start for r in rows_
              if r.kind == "op" and r.name == PREFIX + name and (
                  window is None or (r.start >= window[0]
                                     and r.end <= window[1])))
    return tot / 1e6 / steps
