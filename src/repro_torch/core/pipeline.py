"""Computation pipelining schedules (paper §4.3 / Fig 9, FPDeep adaptation).

Two schedulers over a chain of stages (each stage = the set of cores holding one
partition layer), processing ``n_units`` fine-grained work units (feature-map rows in
FPDeep; micro-batches in the LM pipeline runtime):

* ``layerwise``   — stage s starts only after stage s-1 finished *all* units
  (the baseline in Fig 9a: most cores idle at any instant),
* ``fpdeep``      — stage s starts unit m as soon as stage s-1 finished unit m
  (fine-grained pipelining, Fig 9b),
* ``one_f_one_b`` — 1F1B micro-batch schedule used by the LM pipeline-parallel
  runtime (fwd/bwd interleaving with bounded activation liveness).

A training round is modeled as forward through stages 1..S then backward S..1 with a
configurable bwd/fwd cost ratio (2.0 by default — BP engine does dense MACs while the
FP engine is select+add).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Schedule:
    makespan: float
    # events: (stage, unit, phase, start, end); phase in {"fwd", "bwd"}
    events: list
    n_stages: int

    def _n_engines(self) -> int:
        """Each core has separate FP and BP engines (paper Fig 2), so fwd and
        bwd of different units may overlap on one stage."""
        phases = {ph for (_, _, ph, _, _) in self.events}
        return 2 if len(phases) > 1 else 1

    def utilization_waveform(self, resolution: int = 200):
        """(t_grid, active_fraction(t)) — the Fig 9 waveforms."""
        t = np.linspace(0.0, self.makespan, resolution)
        active = np.zeros((resolution,))
        for (stage, unit, phase, s, e) in self.events:
            active += ((t >= s) & (t < e)).astype(float)
        return t, active / max(self.n_stages * self._n_engines(), 1)

    def mean_utilization(self) -> float:
        busy = sum(e - s for (_, _, _, s, e) in self.events)
        denom = self.makespan * self.n_stages * self._n_engines()
        return busy / denom if self.makespan else 0.0


def _train_chain(stage_times, bwd_ratio):
    """Stage sequence of one training round: fwd 0..S-1 then bwd S-1..0."""
    fwd = [(i, t, "fwd") for i, t in enumerate(stage_times)]
    bwd = [(i, t * bwd_ratio, "bwd") for i, t in reversed(list(enumerate(stage_times)))]
    return fwd + bwd


def layerwise(stage_times, n_units: int, bwd_ratio: float = 2.0,
              training: bool = True) -> Schedule:
    chain = _train_chain(stage_times, bwd_ratio) if training else \
        [(i, t, "fwd") for i, t in enumerate(stage_times)]
    events, t0 = [], 0.0
    for (stage, t_unit, phase) in chain:
        for m in range(n_units):
            events.append((stage, m, phase, t0, t0 + t_unit))
            t0 += t_unit
    return Schedule(makespan=t0, events=events, n_stages=len(stage_times))


def fpdeep(stage_times, n_units: int, bwd_ratio: float = 2.0,
           training: bool = True) -> Schedule:
    chain = _train_chain(stage_times, bwd_ratio) if training else \
        [(i, t, "fwd") for i, t in enumerate(stage_times)]
    n_steps = len(chain)
    finish = np.zeros((n_steps + 1, n_units + 1))  # finish[k, m+1] of unit m at step k
    events = []
    for k, (stage, t_unit, phase) in enumerate(chain):
        for m in range(n_units):
            start = max(finish[k, m + 1], finish[k + 1, m])
            end = start + t_unit
            finish[k + 1, m + 1] = end
            events.append((stage, m, phase, start, end))
    return Schedule(makespan=float(finish[-1, -1]), events=events,
                    n_stages=len(stage_times))


def one_f_one_b(n_stages: int, n_micro: int, fwd_time: float = 1.0,
                bwd_time: float = 2.0):
    """1F1B schedule: returns per-stage ordered op list [(phase, microbatch)].

    Warmup of (n_stages - stage - 1) forwards, then alternate 1F1B, then drain.
    This op order drives the shard_map pipeline runtime; here it also feeds the
    utilization comparison against layerwise/fpdeep.
    """
    assert n_micro >= n_stages, "1F1B needs n_micro >= n_stages for full pipe"
    per_stage = []
    for s in range(n_stages):
        warmup = min(n_stages - s - 1, n_micro)
        ops = [("fwd", m) for m in range(warmup)]
        f, b = warmup, 0
        while b < n_micro:
            if f < n_micro:
                ops.append(("fwd", f)); f += 1
            ops.append(("bwd", b)); b += 1
        per_stage.append(ops)
    # simulate timing with dependencies: fwd(s,m) needs fwd(s-1,m); bwd(s,m)
    # needs bwd(s+1,m) and (locally) previous op on s.
    done_f = {}
    done_b = {}
    stage_clock = [0.0] * n_stages
    events = []
    # iterate ops round-robin until all scheduled (dependency-driven)
    pending = [list(ops) for ops in per_stage]
    progressed = True
    while progressed:
        progressed = False
        for s in range(n_stages):
            while pending[s]:
                phase, m = pending[s][0]
                if phase == "fwd":
                    dep = done_f.get((s - 1, m), 0.0) if s > 0 else 0.0
                    if s > 0 and (s - 1, m) not in done_f:
                        break
                    start = max(stage_clock[s], dep)
                    end = start + fwd_time
                    done_f[(s, m)] = end
                else:
                    dep = done_b.get((s + 1, m), 0.0) if s < n_stages - 1 else \
                        done_f.get((s, m), 0.0)
                    if s < n_stages - 1 and (s + 1, m) not in done_b:
                        break
                    start = max(stage_clock[s], dep)
                    end = start + bwd_time
                    done_b[(s, m)] = end
                stage_clock[s] = end
                events.append((s, m, phase, start, end))
                pending[s].pop(0)
                progressed = True
    makespan = max(e for (_, _, _, _, e) in events)
    return Schedule(makespan=makespan, events=events, n_stages=n_stages)
