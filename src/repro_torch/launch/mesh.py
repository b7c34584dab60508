"""Device meshes on ``torch.distributed`` (``repro.launch.mesh``).

Importing this module touches no process group; every function here is
called on every rank of the job, since building a DeviceMesh creates its
sub-groups collectively.

``make_production_mesh``: single pod ``(16, 16)`` over ``("data",
"model")``; multi-pod ``(2, 16, 16)`` over ``("pod", "data", "model")``.
``placement`` reorders the ranks with an assignment from the paper's
optimizer: logical mesh position ``i`` is served by physical rank
``placement[i]``.

``init_distributed`` joins the job torchrun (or a test's spawn) describes
through ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``: NCCL on the card, gloo
only where the caller asks for the CPU.
"""
from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device


def init_distributed(device=None) -> torch.device:
    """Join the process group of ``RANK``/``WORLD_SIZE`` (``MASTER_ADDR`` and
    ``MASTER_PORT`` as torchrun sets them), unless already joined, and
    return this rank's device: ``cuda:LOCAL_RANK`` (NCCL) unless ``device``
    asks for the CPU (gloo)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=600),
            **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev


def _device_type() -> str:
    """``cuda`` on an NCCL world, and on a world of the ``fake`` backend
    (the dry run's) where torch has CUDA; else ``cpu``."""
    backend = dist.get_backend()
    return "cuda" if backend == "nccl" or (
        backend == "fake" and torch.cuda.is_available()) else "cpu"


def make_production_mesh(*, multi_pod: bool = False, placement=None,
                         devices=None) -> DeviceMesh:
    """The production mesh over ranks ``devices`` (default: the world's,
    in order), reordered by ``placement``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    n = math.prod(shape)
    if len(ranks) < n:
        raise ValueError(f"need {n} devices, have {len(ranks)}")
    ranks = ranks[:n]
    if placement is not None:
        ranks = [ranks[int(p)] for p in np.asarray(placement)]
    return DeviceMesh(_device_type(), torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> DeviceMesh:
    """A small mesh over the first ``prod(shape)`` ranks of the world."""
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))
