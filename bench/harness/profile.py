"""The traced window: ``torch.profiler`` over a few steady steps, reduced to
device intervals, the harness's own host spans and the arithmetic the
per-layer readers share (busy time as the union of device intervals, idle
gaps named by the host span they fall in, time by kernel name).

Host spans are ``record_function`` ranges the harness opens around its own
calls (``bench.feed``, ``bench.train_step``, ``bench.sync``, and
``bench.window`` around the whole traced window); the program has none on
the training path.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class DeviceTrace:
    kernels: list      # [(name, start_ns, end_ns)] compute kernels
    ops: list          # every device operation: kernels, copies, fills
    spans: list        # [(name, start_ns, end_ns)] the harness's host spans
    window: tuple      # (start_ns, end_ns) of the bench.window span
    steps: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def span(name: str):
    return record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def traced():
    """Profile CPU and CUDA activity inside the scope; yields the profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _kind(e) -> str | None:
    """``kernel``, ``device`` (a copy or a fill on the card), ``span`` (a
    harness span on the host) or None. Kineto events of torch 2.11 carry
    no activity type: a device event is told by its device and name."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith(SPAN_PREFIX):         # a span's copy on the card
            return None
        return "device" if name.startswith(("Memcpy", "Memset")) else "kernel"
    return "span" if name.startswith(SPAN_PREFIX) else None


def _kineto_rows(prof):
    """``(kind, name, start_ns, end_ns)`` of every event the readers use."""
    rows = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is not None:
            rows.append((kind, e.name(), e.start_ns(),
                         e.start_ns() + e.duration_ns()))
    return rows


def reduce(prof, steps: int) -> DeviceTrace:
    rows = _kineto_rows(prof)
    kernels = [(n, s, e) for k, n, s, e in rows if k == "kernel"]
    ops = kernels + [(n, s, e) for k, n, s, e in rows if k == "device"]
    spans = [(n[len(SPAN_PREFIX):], s, e) for k, n, s, e in rows
             if k == "span"]
    windows = [(s, e) for n, s, e in spans if n == "window"]
    if not windows:
        raise RuntimeError("the profile holds no bench.window span")
    return DeviceTrace(sorted(kernels, key=lambda r: r[1]),
                       sorted(ops, key=lambda r: r[1]), spans, windows[0],
                       steps)


def merged(intervals, lo: int, hi: int) -> list:
    """The union of ``[(name, start, end)]`` clipped to ``[lo, hi]``, as
    sorted disjoint ``(start, end)`` pairs."""
    out = []
    for _, s, e in sorted(intervals, key=lambda r: r[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_ns(trace: DeviceTrace) -> int:
    lo, hi = trace.window
    return sum(e - s for s, e in merged(trace.ops, lo, hi))


def host_span_at(trace: DeviceTrace, t: int) -> str:
    """The innermost harness span (the latest to open) covering host time
    ``t``; ``outside`` where none does."""
    best = None
    for name, s, e in trace.spans:
        if s <= t < e and (best is None or (s, -e) > best[1]):
            best = (name, (s, -e))
    return best[0] if best else "outside"


def idle_gaps(trace: DeviceTrace, top: int = 10) -> list:
    """The ``top`` longest stretches of the window with no device
    operation, ``[[host span at the gap's start, seconds]]``."""
    lo, hi = trace.window
    gaps, prev = [], lo
    for s, e in merged(trace.ops, lo, hi):
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[host_span_at(trace, s), (e - s) / 1e9] for s, e in gaps[:top]]


def kernel_seconds(trace: DeviceTrace) -> dict:
    """Device seconds a kernel name, summed over the window."""
    lo, hi = trace.window
    out = defaultdict(float)
    for name, s, e in trace.kernels:
        if s >= lo and e <= hi:
            out[name] += (e - s) / 1e9
    return out


def matching_seconds(trace: DeviceTrace, keep) -> float:
    """Device seconds of the window's kernels whose name ``keep`` accepts."""
    return sum(t for name, t in kernel_seconds(trace).items() if keep(name))


def breakdown(trace: DeviceTrace, top: int = 10) -> dict:
    ops = sorted(kernel_seconds(trace).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], t] for n, t in ops[:top]],
            "idle_gaps": idle_gaps(trace, top)}


def kernel_count(trace: DeviceTrace) -> int:
    lo, hi = trace.window
    return sum(1 for _, s, e in trace.kernels if s >= lo and e <= hi)
