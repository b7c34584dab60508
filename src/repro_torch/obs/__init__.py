"""Tracing and flow reports for the deployment stack.

* :class:`Recorder` / :func:`maybe_span` — spans, events, counters, gauges
  and histograms with JSONL and Chrome-trace export (:mod:`.recorder`).
* :func:`profile_range` — a range ``repro_torch.<name>`` in
  ``torch.profiler``'s trace while a profiler runs, a no-op otherwise (the
  training step's spans; every recorder span opens one too).
* :func:`flow_report` — per-link NoC load of a placement with hotspot top-k,
  Gini/CoV imbalance, per-chip and inter-chip bytes and an ASCII heatmap
  (:mod:`.flow`; ``python -m repro_torch.deploy report``).
* :func:`bench_time` / :func:`bench_percentiles` / :func:`percentiles` —
  host-clock timing helpers (a caller timing device work synchronises
  before the clock stops).
"""
from .recorder import (NULL_RECORDER, Recorder, Span,  # noqa: F401
                       bench_percentiles, bench_time, maybe_span,
                       percentiles, profile_range, read_jsonl, timed)
from .flow import FlowReport, ascii_heatmap, cov, flow_report, gini  # noqa: F401
