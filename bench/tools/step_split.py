"""A training cell's step split by program span: the cell's program, warmed
up, runs ``--steps`` steps under ``torch.profiler`` as the benchmark's
traced window runs them, and every device operation of the window is
attributed to the program's span that launched it and to its pass
(``bench/harness/spans.py``).

    python bench/tools/step_split.py --workload train.internlm2-1.8b.b32s4k \\
        --seed 7 --out split.json

Prints, to standard error, the device ms a step of each (span, pass), the
span metrics (``spans.METRICS``), the share that only a ``train.*`` span
owns, the step's device time in disjoint parts (GEMMs and flash by kernel
name first, as ``gemm_ms_per_step`` and ``attn_ms_per_step`` match them),
the ten device operations with the most time split by owning span,
the host ms a step inside ``train.step`` (the step's enqueue),
the benchmark's own readings of the same window (kernels a step, busy
and idle) and its ten longest idle gaps named by the harness's span and by
the program's; then one JSON line on standard output, written to
``--out`` too. Runs no reference and checks nothing: the benchmark's own
run does. Needs the cell's card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def _metric_module(root, name):
    """``bench/metrics/<name>.py`` as the harness loads it."""
    spec = importlib.util.spec_from_file_location(
        "split_" + name, os.path.join(root, "bench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=int, default=3,
                    help="untraced steps first (the first builds kernels)")
    ap.add_argument("--steps", type=int, default=None,
                    help="traced steps (default: the cell's trace_steps)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--root", default=ROOT,
                    help="checkout holding BENCHMARK.json and bench/")
    args = ap.parse_args(argv)

    import torch
    from pathlib import Path
    from bench.harness import profile as P
    from bench.harness import spans as S
    from bench.harness import train
    from bench.harness.spec import Cell
    from bench.harness.tokens import TokenFeed

    cell = Cell(args.workload, root=Path(args.root),
                bench=Path(args.root) / "bench")
    dev = torch.device(args.device)
    n = args.steps or cell.spec["trace_steps"]
    feed = train.Feed(TokenFeed.from_traffic(
        cell.spec["traffic"], cell.config["vocab_size"], args.seed), dev)
    program = train.Program(cell, args.seed, dev)
    _, warm_s, _ = train.run_steps(program, feed, dev, 0, count=args.warm)
    train.log(f"{args.warm} warm-up steps: {warm_s!r} s")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with P.traced() as prof:
        with P.span("window"):
            _, elapsed, _ = train.run_steps(program, feed, dev, args.warm,
                                            count=n, spans=True)
    t = time.perf_counter()
    trace = P.reduce(prof, n)
    rows = S.rows(prof)
    on_card = sum(1 for e in prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")
                  and e.name().startswith(S.PREFIX))
    del prof
    split = S.read(rows, trace.window, n)
    train.log(f"{n} traced steps in {elapsed!r} s; {len(rows)} rows, "
              f"{len(split.owned)} device operations in the window; "
              f"attributed in {time.perf_counter() - t!r} s")

    gemm = _metric_module(ROOT, "gemm_ms_per_step")
    attn = _metric_module(ROOT, "attn_ms_per_step")
    busy_ms = P.busy_ns(trace) / 1e6 / n
    summed = split.ms(lambda o: True)
    window_ms = trace.window_s * 1e3 / n
    main_tid = S.main_thread(rows)
    lo, hi = trace.window
    gaps, prev = [], lo
    for s, e in P.merged(trace.ops, lo, hi):
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:10]
    named = S.span_at(rows, main_tid, [g[0] for g in gaps])
    idle = [[P.host_span_at(trace, g[0]), prog, (g[1] - g[0]) / 1e9]
            for g, prog in zip(gaps, named)]
    anchors = {}
    for o in split.owned:
        anchors[o.anchor] = anchors.get(o.anchor, 0) + 1

    out = {
        "workload": args.workload, "seed": args.seed, "steps": n,
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "traced_tokens_per_s": n * cell.spec["traffic"]["batch"]
        * cell.spec["traffic"]["seq"] / elapsed,
        "metrics": split.metrics(),
        "fallback_share": split.fallback_share(),
        "by_rule_ms": {str(k): v for k, v in split.rules().items()},
        "anchors": anchors,
        "parts_ms": split.parts(gemm.is_gemm, attn.is_flash),
        "device_ms_summed": summed, "device_ms_busy": busy_ms,
        "window_ms": window_ms,
        "kernels_per_step": P.kernel_count(trace) / n,
        "device_idle_pct": 100.0 * (1.0 - busy_ms / window_ms),
        "gemm_ms_per_step": P.matching_seconds(trace, gemm.is_gemm) * 1e3 / n,
        "attn_ms_per_step": P.matching_seconds(trace, attn.is_flash) * 1e3 / n,
        "program_ranges_on_card": on_card,
        "host_ms": {name: S.host_ms(rows, name, n, trace.window)
                    for name in ("train.step", "train.forward",
                                 "train.backward", "optim.adamw")},
        "idle_gaps": idle,
        "table": [list(r) for r in split.table()],
        "by_kernel": [[n[:160], ms, owners]
                      for n, ms, owners in split.by_kernel(16)],
    }
    for span, pass_, ms, k in out["table"]:
        train.log(f"span {span:<22} {pass_:<10} {ms:10.3f} ms {k:8.1f} "
                  f"kernels a step")
    for name, v in out["metrics"].items():
        train.log(f"metric {name}: {v!r}")
    for name, v in out["parts_ms"].items():
        train.log(f"part {name:<28} {v:10.3f} ms a step")
    train.log(f"parts sum {sum(out['parts_ms'].values())!r} ms a step; "
              f"device ops summed {summed!r}, busy {busy_ms!r}, window "
              f"{window_ms!r}")
    train.log(f"only train.* or nothing owns {100 * split.fallback_share()!r}% "
              f"of the device time; by rule {out['by_rule_ms']}; anchors "
              f"{anchors}")
    train.log(f"host ms a step: {out['host_ms']}")
    for name, ms, owners in out["by_kernel"]:
        train.log(f"kernel {name[:70]} {ms:.3f} ms a step: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in owners.items()))
    for g in idle:
        train.log(f"idle gap {g[2] * 1e3:.3f} ms: harness {g[0]}, program "
                  f"{g[1]}")
    train.log(f"kernels a step {out['kernels_per_step']!r}; program ranges "
              f"copied onto the card: {on_card}")
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
