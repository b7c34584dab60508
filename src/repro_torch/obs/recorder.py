"""Structured tracing and metrics for the deployment stack.

One dependency-free :class:`Recorder` collects everything a run emits:

* **spans** — ``with rec.span("deploy.place", method="sa") as sp: ...``
  records a timed region (nesting tracked, attrs attached). The yielded
  :class:`Span` always carries ``duration_s`` — even on a disabled recorder —
  so callers can use spans as their *only* timing primitive (the deployment
  engine's stage times and ``PlacementResult.wall_time_s`` are span
  durations).
* **events** — ``rec.event("sa.iter", cost=..., accepted=True)``: the
  per-iteration search-trajectory telemetry the optimizers emit.
* **counters / gauges / histograms** — ``rec.count("noc_batch.dispatch")``,
  ``rec.gauge("sa.temperature", t)``, ``rec.observe("service.latency_s", dt)``.
  Counters are deterministic (they count algorithmic work, not time), which is
  what lets ``benchmarks/check_regression.py`` gate them in CI.

Export formats:

* **JSONL** (:meth:`Recorder.write_jsonl` / :func:`read_jsonl`) — one event
  per line, the machine-readable artifact CI uploads;
* **Chrome trace** (:meth:`Recorder.write_chrome_trace`) — a
  ``chrome://tracing`` / Perfetto-loadable ``traceEvents`` JSON: spans as
  complete ("X") events, counters as "C" samples, point events as instants.

The disabled path is zero-overhead by construction: every instrumentation
site in the hot loops is guarded by ``if recorder is not None`` (the hooks
thread ``recorder=None`` by default), and :func:`maybe_span` degrades to a
bare perf_counter pair.
"""
from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager


@dataclasses.dataclass
class Span:
    """A timed region; ``duration_s`` is valid after the ``with`` block."""
    name: str
    t_start_s: float = 0.0
    duration_s: float = 0.0
    attrs: dict | None = None


class Recorder:
    """Per-run collector of spans, events, counters, gauges, histograms.

    ``enabled=False`` builds a recorder that stores nothing but whose
    :meth:`span` still measures durations — the engine's internal default, so
    timing fields stay populated with or without tracing.
    """

    def __init__(self, enabled: bool = True,
                 clock=time.perf_counter):
        self.enabled = enabled
        self.events: list[dict] = []
        self._clock = clock
        self._t0 = clock()
        self._depth = 0
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, list] = {}

    # ---- time base --------------------------------------------------------
    def _now(self) -> float:
        """Seconds since recorder creation (the trace time base)."""
        return self._clock() - self._t0

    # ---- spans ------------------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs):
        """Timed region. Yields a :class:`Span` whose ``duration_s`` is set on
        exit whether or not the recorder is enabled."""
        sp = Span(name, t_start_s=self._now(), attrs=attrs or None)
        self._depth += 1
        t0 = self._clock()
        try:
            yield sp
        finally:
            sp.duration_s = self._clock() - t0
            self._depth -= 1
            if self.enabled:
                ev = {"kind": "span", "name": name, "ts": sp.t_start_s,
                      "dur": sp.duration_s, "depth": self._depth}
                if attrs:
                    ev["attrs"] = attrs
                self.events.append(ev)

    # ---- point events -----------------------------------------------------
    def event(self, name: str, **attrs) -> None:
        if not self.enabled:
            return
        ev = {"kind": "event", "name": name, "ts": self._now()}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)

    # ---- metrics ----------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        """Monotonic counter (deterministic: counts work, not time)."""
        if not self.enabled:
            return
        self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins instantaneous measurement."""
        if not self.enabled:
            return
        self._gauges[name] = value
        self.events.append({"kind": "gauge", "name": name, "ts": self._now(),
                            "value": float(value)})

    def observe(self, name: str, value: float) -> None:
        """Add one sample to the named histogram."""
        if not self.enabled:
            return
        self._hists.setdefault(name, []).append(float(value))

    @property
    def counters(self) -> dict:
        return dict(self._counters)

    @property
    def gauges(self) -> dict:
        return dict(self._gauges)

    def histogram(self, name: str) -> list:
        return list(self._hists.get(name, []))

    def histogram_summary(self, name: str) -> dict | None:
        """{count, min, max, mean, p50, p99} of the named histogram."""
        samples = self._hists.get(name)
        if not samples:
            return None
        return {"count": len(samples), **percentiles(samples)}

    def histogram_summaries(self) -> dict:
        """All histogram summaries at once — the service's /stats payload."""
        return {name: self.histogram_summary(name) for name in self._hists}

    # ---- export -----------------------------------------------------------
    def _tail_events(self) -> list[dict]:
        """Counter totals + histogram summaries as final snapshot events, so
        the JSONL artifact is self-contained."""
        tail = []
        ts = self._now()
        if self._counters:
            tail.append({"kind": "counters", "name": "counters", "ts": ts,
                         "values": dict(self._counters)})
        for name in self._hists:
            tail.append({"kind": "histogram", "name": name, "ts": ts,
                         "summary": self.histogram_summary(name)})
        return tail

    def write_jsonl(self, path: str) -> str:
        """One JSON object per line: every event, then counter/histogram
        snapshots. Round-trips through :func:`read_jsonl`."""
        with open(path, "w") as f:
            for ev in self.events + self._tail_events():
                f.write(json.dumps(ev) + "\n")
        return path

    def chrome_trace(self) -> dict:
        """``chrome://tracing`` / Perfetto ``traceEvents`` JSON object."""
        out = []
        for ev in self.events:
            ts_us = ev["ts"] * 1e6
            if ev["kind"] == "span":
                rec = {"name": ev["name"], "ph": "X", "ts": ts_us,
                       "dur": ev["dur"] * 1e6, "pid": 0, "tid": 0}
                if ev.get("attrs"):
                    rec["args"] = ev["attrs"]
            elif ev["kind"] == "gauge":
                rec = {"name": ev["name"], "ph": "C", "ts": ts_us,
                       "pid": 0, "tid": 0, "args": {"value": ev["value"]}}
            else:
                rec = {"name": ev["name"], "ph": "i", "ts": ts_us,
                       "pid": 0, "tid": 0, "s": "t"}
                if ev.get("attrs"):
                    rec["args"] = ev["attrs"]
            out.append(rec)
        meta = {"counters": dict(self._counters),
                "histograms": {k: self.histogram_summary(k)
                               for k in self._hists}}
        return {"traceEvents": out, "otherData": meta,
                "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def read_jsonl(path: str) -> list[dict]:
    """Parse a :meth:`Recorder.write_jsonl` artifact back into event dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


#: Disabled sentinel recorder: spans still measure, nothing is stored.
NULL_RECORDER = Recorder(enabled=False)


@contextmanager
def maybe_span(recorder: Recorder | None, name: str, **attrs):
    """``recorder.span`` when a recorder is attached, else a plain timed
    :class:`Span` (no storage) — the idiom for optional instrumentation."""
    if recorder is not None:
        with recorder.span(name, **attrs) as sp:
            yield sp
        return
    sp = Span(name)
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        sp.duration_s = time.perf_counter() - t0


def percentiles(samples, qs=(50, 99)) -> dict:
    """{min, max, mean, p50, p99, ...} over a sample list — the
    latency-percentile summary the benchmark suites and the future placement
    service report (dependency-light: plain sorted-list interpolation)."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        raise ValueError("percentiles() needs at least one sample")
    out = {"min": xs[0], "max": xs[-1], "mean": sum(xs) / len(xs)}
    n = len(xs)
    for q in qs:
        # linear interpolation between closest ranks (numpy default method)
        pos = (q / 100) * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        out[f"p{q:g}"] = xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
    return out
