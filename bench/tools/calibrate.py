"""Readings that set a training cell's limits: on each seed, the sound
program, its controls and its faults through the cell's checked steps,
each held against one reference pass; one JSON line a reading.

    python bench/tools/calibrate.py --workload train.internlm2-1.8b.b32s4k \\
        --seeds 11 12 13 --variants sound control_int8 half_batch

Variants: ``sound`` (the program as the cell runs it), ``control_int8``
(the program's own int8 AdamW moments, below the configuration's
float32), ``half_batch`` (the loss over the first half of the rows),
``frozen`` (a step that leaves the state as it was). The benchmark's own runs run none of these. Needs the cell's card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["sound"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT,
                    help="checkout holding BENCHMARK.json and bench/")
    args = ap.parse_args(argv)

    import torch
    from bench.harness import check, train
    from bench.harness.spec import Cell
    from bench.harness.tokens import TokenFeed

    from pathlib import Path
    cell = Cell(args.workload, root=Path(args.root),
                bench=Path(args.root) / "bench")
    dev = torch.device(args.device)
    k = cell.spec["checked_steps"]
    for seed in args.seeds:
        feed = train.Feed(TokenFeed.from_traffic(
            cell.spec["traffic"], cell.config["vocab_size"], seed), dev)
        progs, specs = {}, None
        for variant in args.variants:
            t = time.perf_counter()
            program = train.Program(cell, seed, dev,
                                    None if variant == "sound" else variant)
            progs[variant] = train.checked_steps(program, cell, seed, feed,
                                                 dev, k)
            progs[variant]["nonfinite"] = 0
            specs = program.specs
            program.free()
            del program
            train.free_device()
            train.log(f"seed {seed} {variant}: {time.perf_counter() - t!r} s")
        t = time.perf_counter()
        ref = train.reference_readings(cell, specs, seed, dev, k)
        train.log(f"seed {seed} reference: {time.perf_counter() - t!r} s")
        train.free_device()
        for variant, prog in progs.items():
            values = check.readings(prog, ref)
            ok, _ = check.judge(values, cell.spec["limits"])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "correct": ok,
                              "losses": prog["losses"],
                              "ref_losses": ref["losses"], **values}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
