"""Training launcher (``repro.launch.train``): the end-to-end training loop.

Runs a real training loop: the synthetic data pipeline, the train step
(AdamW, global-norm clip, optional int8 error-feedback gradient
compression), periodic async checkpoints and restart on relaunch (it resumes
from the latest checkpoint in ``--ckpt-dir``). On the card, each layer's
attention runs the flash kernel forward and the flash backward kernel::

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 6 --batch 2 --seq 4096                 # full width, one card
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --steps 4 --batch 2 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch seamless-m4t-medium --steps 4 --batch 4 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --device cpu --steps 6 --batch 2 --seq 32 --ckpt-dir ckpt

Weights are random, drawn from ``--seed``. The enc-dec family (seamless)
trains on rows of ``--seq // 2`` source frames (seeded normal embeddings,
the frontend's stub) and ``--seq // 2`` decoder tokens, as in the
reference.

``--mesh DxM`` trains on a ``(D, M)`` mesh over ``("data", "model")``, one
rank a device, as the reference's launcher does: the parameters are
replicated, the batch is sharded over ``data`` (each rank draws its own
rows) and the step runs inside ``set_context(mesh)``, so activations keep
the batch sharding and MoE layers run expert-parallel over ``model``. The
job has ``D·M`` ranks (torchrun's ``WORLD_SIZE``); rank 0 alone prints and
writes checkpoints::

    PYTHONPATH=src torchrun --nproc-per-node 1 -m repro_torch.launch.train \
        --arch internlm2-1.8b --steps 4 --batch 2 --seq 4096 --mesh 1x1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import store
from ..configs.registry import get_config, get_smoke_config
from ..data.pipeline import DataConfig, batch_for_step
from ..device import resolve_device
from ..models import encdec, lm
from ..models.encdec import EncDecConfig
from ..models.specs import materialize, tree_map
from ..sharding import rules as R
from ..train.optim import AdamWConfig
from ..train.step import (TrainConfig, error_state_init, init_optimizer,
                          make_train_step)
from .mesh import init_distributed, make_test_mesh


def init_params(cfg, seed: int, device):
    """The model's parameters drawn from ``seed`` on ``device``."""
    specs = (encdec.encdec_specs(cfg) if isinstance(cfg, EncDecConfig)
             else lm.lm_specs(cfg))
    return materialize(specs,
                       torch.Generator(device=device).manual_seed(seed),
                       device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--mesh", default="", help="e.g. '2x4' data x model")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    is_ed = isinstance(cfg, EncDecConfig)
    mesh = None
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
        dev = init_distributed(args.device)
        mesh = make_test_mesh((d, m), ("data", "model"))
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"--mesh {args.mesh} needs {mesh.size()} ranks, "
                             f"the job has {dist.get_world_size()}")
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)

    tcfg = TrainConfig(adam=AdamWConfig(lr=args.lr, grad_clip=1.0),
                       grad_compression=args.grad_compression)
    dcfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
                      seed=args.seed)

    def loss_fn(params, bt):
        if is_ed:
            return encdec.encdec_loss(params, cfg, bt["frames"],
                                      bt["tokens"], bt["labels"])
        return lm.lm_loss(params, cfg, bt["tokens"], bt["labels"],
                          bt.get("prefix"))

    raw_step = make_train_step(loss_fn, tcfg)
    compressed = tcfg.grad_compression == "int8_ef"

    def step_fn(*a):
        if mesh is None:
            return raw_step(*a)
        with R.set_context(mesh):
            return raw_step(*a)

    # ---- init or restore (restart-on-relaunch fault tolerance) ----
    start_step = 0
    params = init_params(cfg, args.seed, dev)
    if mesh is not None:
        rep = R.NamedSharding(mesh, ())
        params = tree_map(lambda p: R.distribute(p, rep), params)
    opt = init_optimizer(params, tcfg)
    if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
        restored, start_step, _ = store.restore(
            args.ckpt_dir, {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        log(f"restored checkpoint at step {start_step}")
    err_state = error_state_init(params) if compressed else None

    def host(a):
        """A host array of the batch's rows on ``dev``; over a mesh, laid
        out as the batch."""
        t = torch.as_tensor(a, device=dev)
        if mesh is None:
            return t
        return R.distribute(t, R.NamedSharding(
            mesh, R.batch_partition(mesh, t.dim())))

    def make_batch(i):
        tokens, labels = batch_for_step(dcfg, i, mesh)
        if mesh is None:
            tokens, labels = (torch.as_tensor(a, device=dev)
                              for a in (tokens, labels))
        bt = {"tokens": tokens.long(), "labels": labels.long()}
        if is_ed:
            rng = np.random.default_rng(1000 + i)
            bt["frames"] = host(
                rng.normal(size=(args.batch, args.seq // 2, cfg.d_model))
                .astype(np.float32))
            bt["tokens"] = bt["tokens"][:, : args.seq // 2]
            bt["labels"] = bt["labels"][:, : args.seq // 2]
        elif cfg.prefix_len:
            rng = np.random.default_rng(2000 + i)
            bt["prefix"] = host(
                rng.normal(size=(args.batch, cfg.prefix_len, cfg.d_model))
                .astype(np.float32))
            bt["tokens"] = bt["tokens"][:, : args.seq - cfg.prefix_len]
            bt["labels"] = bt["labels"][:, : args.seq - cfg.prefix_len]
        return bt

    t0 = time.time()
    for i in range(start_step, args.steps):
        bt = make_batch(i)
        if compressed:
            params, opt, metrics, err_state = step_fn(params, opt, bt,
                                                      err_state)
        else:
            params, opt, metrics = step_fn(params, opt, bt)
        if i % 5 == 0 or i == args.steps - 1:
            log(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"({time.time()-t0:.1f}s)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            store.save_async(args.ckpt_dir, i + 1,
                             {"params": params, "opt": opt},
                             extra={"data_step": i + 1})
    store.wait()
    log("done")
    return params


if __name__ == "__main__":
    main()
