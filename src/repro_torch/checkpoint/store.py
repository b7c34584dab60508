"""Checkpoints with restart (``repro.checkpoint.store``).

Layout, the reference's:  ``<dir>/step_<N>/``

* ``manifest.json``: step, leaf keys, caller's extra state;
* ``arrays.npz``: one entry per leaf, keyed by its ``/``-joined path in the
  nested dict (``params/seg0/attn/wq``, ``opt/m/...``, ``opt/step``, an int8
  moment's ``.../codes`` and ``.../scale``), as the reference keys its
  pytree paths.

Features: atomic commit (write a tmp dir, then rename), so a preempted save
never corrupts the latest checkpoint; async save (the device-to-host copy on
the caller's thread, serialisation in a background thread); restore onto
the template's devices and dtypes; retention of the last ``keep``
checkpoints.

bfloat16 leaves are stored as their raw 2-byte bits. numpy has no bfloat16:
the reference's ``np.savez`` of such a leaf writes a 2-byte void dtype
(``|V2``), and the port writes the same and reads either back into
``torch.bfloat16`` bit for bit.

Meshes: a DTensor leaf is saved whole (``full_tensor()``, a collective every
rank of its mesh takes part in); rank 0 alone writes, and every rank waits
at a barrier until the write is committed. Restore is elastic: each rank
reads the full arrays and keeps its own shard, laid out by ``shardings``
(a tree of ``sharding.rules.NamedSharding`` beside the template), or else by
a DTensor template leaf's own mesh and placements, so a run checkpointed on
N ranks restarts on M. The files do not change, so checkpoints cross
between the packages in both directions.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..sharding.rules import mesh_device

_SEP = "/"


def _flatten(tree, path=()):
    """``{"/"-joined path: leaf}`` over a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, path + (str(k),)))
        return out
    return {_SEP.join(path): tree}


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory (the training loop updates its
    tensors in place, so the copy must not share storage); bfloat16 as its
    2-byte bits."""
    if isinstance(leaf, DTensor):
        leaf = leaf.detach().full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def _from_host(arr: np.ndarray, like: torch.Tensor,
               sharding=None) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on ``like``'s device; a
    DTensor laid out as ``sharding`` (a ``NamedSharding``), else as a
    DTensor ``like``, each rank keeping its own shard."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if like.dtype != torch.bfloat16:
            raise TypeError(f"a stored bfloat16 leaf cannot restore into "
                            f"{like.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if sharding is None and isinstance(like, DTensor):
        mesh, pl = like.device_mesh, like.placements
    elif sharding is not None:
        mesh, pl = sharding.mesh, sharding.placements
    else:
        return t.to(device=like.device, dtype=like.dtype)
    return distribute_tensor(t.to(device=mesh_device(mesh), dtype=like.dtype),
                             mesh, pl, src_data_rank=None)


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def _write(ckpt_dir: str, step: int, arrays: dict, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays), "extra": extra or {}},
                  f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 3):
    """Synchronous atomic save. Returns the checkpoint's directory. In a
    process group every rank calls it; rank 0 writes."""
    arrays = {k: _to_host(v) for k, v in _flatten(tree).items()}
    final = os.path.join(ckpt_dir, f"step_{step}")
    if _writer():
        _write(ckpt_dir, step, arrays, extra)
        _gc(ckpt_dir, keep)
    _barrier()
    return final


_save_thread = None


def save_async(ckpt_dir: str, step: int, tree, extra=None, keep: int = 3):
    """Non-blocking save: the device-to-host copy happens on the caller's
    thread (so the caller may go on updating ``tree`` in place), the write
    in a background thread of rank 0. :func:`wait` joins it."""
    global _save_thread
    wait()
    arrays = {k: _to_host(v) for k, v in _flatten(tree).items()}
    if not _writer():
        return

    def work():
        _write(ckpt_dir, step, arrays, extra)
        _gc(ckpt_dir, keep)

    _save_thread = threading.Thread(target=work, daemon=True)
    _save_thread.start()


def wait():
    """Join the background write; in a process group every rank calls it
    and returns once rank 0's write is committed."""
    global _save_thread
    if _save_thread is not None:
        _save_thread.join()
        _save_thread = None
    _barrier()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: int | None = None,
            shardings=None):
    """Restore into ``template``'s structure, each leaf in its dtype on the
    template leaf's device, or as a DTensor laid out by ``shardings`` (a
    tree of ``NamedSharding`` of the template's structure) or by a DTensor
    template leaf. Returns ``(tree, step, extra)``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        def load(tmpl, shard, path=()):
            if isinstance(tmpl, dict):
                return {k: load(v, None if shard is None else shard[k],
                                path + (str(k),)) for k, v in tmpl.items()}
            return _from_host(data[_SEP.join(path)], tmpl, shard)
        tree = load(template, shardings)
    return tree, manifest["step"], manifest["extra"]


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
