"""Multi-pod dry run (``repro.launch.dryrun``): every (architecture × input
shape × mesh) cell traced on fake tensors over a fake process group of the
production mesh's size, with no card and no allocation.

For each cell: join a world of the ``fake`` backend (one process plays rank
0 of 256 or 512), build the production mesh and the cell
(``launch/cells.py``), trace its step once (``Cell.trace``), and record the
reference's keys: ``memory`` (the memory figures of this rank's local
tensors), ``cost`` (per-device FLOPs, bytes and matrix products of the op
trace, ``core/trace_analysis.py``), ``collectives`` and a three-term
``roofline``. ``trace_s`` takes the place of the reference's ``lower_s`` and
``compile_s``; its ``xla_*_single_visit`` keys have no counterpart. Results
land as JSON in ``results/dryrun_torch/``; a failing cell is recorded as
data.

Usage (on the CPU; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --arch qwen3-moe-30b-a3b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist

from ..configs.registry import cells as all_cells
from ..core.trace_analysis import analyze_trace, collective_entry
from .cells import build_cell
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# H100 SXM constants (NVIDIA's data sheet, at its 700 W limit):
PEAK_FLOPS = 989e12          # dense bf16 / GPU
HBM_BW = 3.35e12             # bytes/s / GPU
NVLINK_BW = 450e9            # bytes/s each way / GPU, within a node
# A system assumption, not a reading of the card: one 400 Gb/s InfiniBand
# NIC per GPU between nodes, as in a DGX H100.
IB_BW = 50e9
NODE_GPUS = 8                # GPUs of one NVLink node (ranks r // 8)
LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


def link_of(ranks) -> str:
    """``nvlink`` for a group within one node of ``NODE_GPUS`` consecutive
    ranks, else ``ib``."""
    return "nvlink" if len({r // NODE_GPUS for r in ranks}) == 1 else "ib"


def collective_links(trace) -> dict:
    """Operand and wire bytes of the trace's collectives by link class."""
    out = {k: {"operand_bytes": 0.0, "wire_bytes": 0.0} for k in LINK_BW}
    for op in trace.ops:
        if "kind" in op.attrs:
            e = collective_entry(op)
            d = out[link_of(op.attrs["group_ranks"])]
            d["operand_bytes"] += e["operand_bytes"] * op.count
            d["wire_bytes"] += e["wire_bytes"] * op.count
    return out


def collective_axes(trace, mesh) -> dict:
    """``{mesh axis: {kind: {"count", "operand_bytes"}}}`` of the trace's
    collectives, each under the mesh dim whose process group it ran on
    (``"other"`` for a group that is no single dim's)."""
    from ..core.gpu_adapter import mesh_axis_of
    out: dict = {}
    for op in trace.ops:
        if "kind" not in op.attrs:
            continue
        d = mesh_axis_of(op.attrs["group_ranks"], mesh)
        name = "other" if d is None else mesh.mesh_dim_names[d]
        e = out.setdefault(name, {}).setdefault(
            op.attrs["kind"], {"count": 0, "operand_bytes": 0.0})
        e["count"] += op.count
        e["operand_bytes"] += (collective_entry(op)["operand_bytes"]
                               * op.count)
    return out


def _join_fake_world(n: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape, multi_pod: bool, out_dir: str,
             overrides=None, tag: str = "", fsdp: bool | None = None,
             on_trace=None) -> dict:
    """Trace one cell and write its record; ``fsdp`` None lets
    ``build_cell`` choose by the parameter count. ``on_trace(trace,
    mesh)``, when given, is called while the world is up (the device-order
    search reads the trace's groups off the mesh)."""
    mesh_name = "multipod" if multi_pod else "pod"
    shape_name = shape if isinstance(shape, str) else shape.name
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
           "tag": tag}
    t0 = time.time()
    joined = not dist.is_initialized()
    try:
        if joined:
            _join_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_chips = mesh.size()
        cell = build_cell(arch, shape, mesh, fsdp=fsdp, overrides=overrides)
        t1 = time.time()
        trace, memory = cell.trace()
        t2 = time.time()
        st = analyze_trace(trace)
        coll = dict(st["collectives"], by_link=collective_links(trace),
                    by_axis=collective_axes(trace, mesh))
        if on_trace is not None:
            on_trace(trace, mesh)
        flops_dev = float(st["flops"])
        bytes_dev = float(st["bytes"])
        rec.update({
            "ok": True,
            "kind": cell.kind,
            "fsdp": cell.fsdp,
            "n_chips": n_chips,
            "n_params": cell.n_params,
            "n_active_params": cell.n_active_params,
            "model_flops": cell.model_flops,
            "build_s": round(t1 - t0, 2),
            "trace_s": round(t2 - t1, 2),
            "n_trace_ops": len(trace.ops),
            "n_unrolled_ops": trace.n_unrolled,
            "memory": memory,
            "cost": {"flops_per_device": flops_dev,
                     "bytes_per_device": bytes_dev,
                     "n_dots": st["n_dots"],
                     "unknown_trip_whiles": st["unknown_trip_whiles"]},
            "collectives": coll,
            "roofline": roofline_terms(flops_dev, bytes_dev, coll,
                                       cell.model_flops, n_chips),
        })
    except Exception as e:  # noqa: BLE001 - record failures as data
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
    rec["total_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def roofline_terms(flops_dev: float, bytes_dev: float, coll: dict,
                   model_flops: float, n_chips: int) -> dict:
    """Three-term roofline (per step, seconds). The collective term puts
    each collective's bytes on NVLink or InfiniBand by its group
    (``coll["by_link"]``, :func:`collective_links`)."""
    links = coll["by_link"]
    compute_t = flops_dev / PEAK_FLOPS
    memory_t = bytes_dev / HBM_BW
    coll_operand_t = sum(v["operand_bytes"] / LINK_BW[k]
                         for k, v in links.items())
    coll_wire_t = sum(v["wire_bytes"] / LINK_BW[k] for k, v in links.items())
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_operand_t,
             "collective_wire_s": coll_wire_t}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    bound = max(compute_t, memory_t, coll_operand_t)
    ideal = (model_flops / n_chips) / PEAK_FLOPS
    terms.update({
        "dominant": dom,
        "useful_flops_ratio": (model_flops / (flops_dev * n_chips)
                               if flops_dev else 0.0),
        "roofline_fraction": ideal / bound if bound > 0 else 0.0,
        "ideal_compute_s": ideal,
    })
    return terms


def compiled_summary(rec) -> str:
    m = rec["memory"]
    c = rec["collectives"]
    return ("  memory_analysis: args=%.2fGiB out=%.2fGiB temp=%.2fGiB | "
            "cost: %.3e flops/dev | collectives: %d ops %.2fMiB operands" % (
                m["argument_bytes"] / 2**30, m["output_bytes"] / 2**30,
                m["temp_bytes"] / 2**30, rec["cost"]["flops_per_device"],
                c["n_ops"], c["operand_bytes"] / 2**20))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="config overrides, e.g. --override remat=full")
    args = ap.parse_args()

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        if v.isdigit():
            v = int(v)
        elif v in ("True", "False"):
            v = v == "True"
        overrides[k] = v
    overrides = overrides or None

    todo = []
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    if args.all:
        for c in all_cells():
            if c["skip"]:
                print(f"SKIP {c['arch']} x {c['shape']}: {c['skip']}")
                continue
            for mp in meshes:
                todo.append((c["arch"], c["shape"], mp))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        for mp in meshes:
            todo.append((args.arch, args.shape, mp))

    n_ok = 0
    for arch, shape, mp in todo:
        mesh_name = "multipod" if mp else "pod"
        suffix = f"_{args.tag}" if args.tag else ""
        path = os.path.join(args.out_dir,
                            f"{arch}__{shape}__{mesh_name}{suffix}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    print(f"CACHED {arch} x {shape} x {mesh_name}")
                    n_ok += 1
                    continue
        rec = run_cell(arch, shape, mp, args.out_dir, overrides=overrides,
                       tag=args.tag)
        if rec["ok"]:
            n_ok += 1
            r = rec["roofline"]
            print(f"OK   {arch} x {shape} x {mesh_name}: "
                  f"trace={rec['trace_s']}s "
                  f"mem={rec['memory']['peak_bytes_per_device']/2**30:.2f}GiB "
                  f"dom={r['dominant']} frac={r['roofline_fraction']:.3f}")
            print(compiled_summary(rec))
        else:
            print(f"FAIL {arch} x {shape} x {mesh_name}: {rec['error']}")
    print(f"{n_ok}/{len(todo)} cells OK")


if __name__ == "__main__":
    main()
