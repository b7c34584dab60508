"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell of ``BENCHMARK.json``.

    python bench/run.py --workload train.internlm2-1.8b.b32s4k --seed 7 \\
        --seconds 10 --trace 0

With ``--trace 0`` the last line of standard output is one JSON object
with the cell's end-to-end metrics; with ``--trace 1`` with its per-layer
metrics, ``device.busy_s`` / ``device.window_s`` and a ``breakdown``. Its
last key, ``checks``, holds each number compared with the reference beside
its limit; the same lines end standard error. Everything else goes to
standard error.

The run needs as many CUDA cards as the cell asks for and exits 2 without
a result where they are missing. It exits 3 without a result where a
module of ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the run is over. Kernel builds and caches stay inside the
checkout (``build/``), at fixed paths.
"""
from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.perf_counter()


def process_start() -> float:
    """``time.perf_counter()``'s reading at the start of this process (from
    ``/proc``; the import of this module where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "bench-cache", sub)

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    import argparse
    import importlib
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch
    from bench.harness import peaks
    from bench.harness.spec import Cell

    cell = Cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    print(f"[bench] card: {peaks.card_state()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    kind = importlib.import_module(f"bench.harness.{cell.spec['kind']}")
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] modules loaded that the port may not use: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"[bench] check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[bench] correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
