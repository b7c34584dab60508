"""A training cell: the port's training step, timed in a closed loop and
checked against the plain reference.

Set-up builds one step (``train.step.make_train_step`` over
``models.lm.lm_loss``, as ``launch.train`` builds it) with its parameters
drawn by the benchmark from the seed and its optimizer state, and drives it
through the cell's checked steps, each on a new batch of the token feed;
the first of them builds and warms every kernel of the cell's one shape.
The program's readings are taken from that same object: each step's loss,
the first gradient from the first moment after one step, the change of
every leaf after the last checked step. The same object then runs the
measured window, a new batch each step, for ``--seconds``: every step
enqueued while the one before it runs, the clock read when a step has
finished. With ``--trace 1`` a few more steps run under the profiler.
Then the program's state is freed and the reference follows the checked
steps from the same weights and batches.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time

import torch

from . import check, peaks
from . import profile as P
from . import weights as W
from .tokens import TokenFeed

MOMENT_TYPES = {"float32": "fp32", "bfloat16": "bf16", "int8": "int8"}
GIB = float(1 << 30)


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _moment32(node):
    """A moment leaf as float32 (an int8 moment is ``{codes, scale}``)."""
    if isinstance(node, dict):
        return node["codes"].float() * node["scale"]
    return node.float()


class Program:
    """The system under test: the port's training step, its parameters and
    optimizer state. ``variant`` plants a control or a fault for the
    calibration and the tests (``VARIANTS``); the benchmark's runs have
    none."""

    def __init__(self, cell, seed: int, device, variant: str | None = None):
        from repro_torch.models import lm
        from repro_torch.train.optim import AdamWConfig
        from repro_torch.train.step import (TrainConfig, init_optimizer,
                                            make_train_step)
        cfg, tr = cell.config, cell.config["training"]
        self.port = cell.family.port_config(cfg)
        stated = {"remat": tr["remat"], "logit_chunk": tr["logit_chunk"],
                  "param_dtype": getattr(torch, tr["param_dtype"])}
        got = {k: getattr(self.port, k) for k in stated}
        if got != stated:
            raise ValueError(f"{cfg['name']}: the port runs {got}, the "
                             f"configuration states {stated}")
        self.specs = lm.lm_specs(self.port)
        moments = MOMENT_TYPES[tr["moments"]]
        if variant == "control_int8":
            moments = "int8"
        self.tcfg = TrainConfig(adam=AdamWConfig(
            lr=tr["lr"], b1=tr["b1"], b2=tr["b2"], eps=tr["eps"],
            weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"],
            state_dtype=moments))
        port = self.port

        def loss_fn(params, bt):
            tokens, labels = bt["tokens"], bt["labels"]
            if variant == "half_batch":
                half = max(1, tokens.shape[0] // 2)
                tokens, labels = tokens[:half], labels[:half]
            return lm.lm_loss(params, port, tokens, labels)

        self.step_fn = make_train_step(loss_fn, self.tcfg)
        if variant == "frozen":
            def frozen(params, opt, bt):
                loss, _ = loss_fn(params, bt)
                return params, opt, {"loss": loss.detach()}
            self.step_fn = frozen
        self.params = W.draw(self.specs, seed, device)
        self.opt = init_optimizer(self.params, self.tcfg)

    def step(self, batch):
        self.params, self.opt, metrics = self.step_fn(self.params, self.opt,
                                                      batch)
        return metrics["loss"]

    def free(self):
        self.params = self.opt = self.step_fn = None


class Feed:
    """The token feed's batches on the device: ``tokens`` and ``labels``
    int64 ``[B, S]``, copied from pinned memory without waiting."""

    def __init__(self, tokens: TokenFeed, device):
        self.tokens, self.device = tokens, device

    def __call__(self, step: int) -> dict:
        rows = torch.from_numpy(self.tokens.rows(step)).long()
        pair = (rows[:, :-1].contiguous(), rows[:, 1:].contiguous())
        if self.device.type == "cuda":
            pair = tuple(t.pin_memory().to(self.device, non_blocking=True)
                         for t in pair)
        return {"tokens": pair[0], "labels": pair[1]}


def _event(device):
    """A marker of the work enqueued so far: a recorded CUDA event, or
    ``True`` on the CPU, whose work is done when it returns."""
    if device.type != "cuda":
        return True
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _wait(ev):
    if isinstance(ev, torch.cuda.Event):
        ev.synchronize()


def run_steps(program, feed, device, start: int, seconds=None, count=None,
              spans: bool = False):
    """Steps ``start, start + 1, ...`` until ``count`` have run or
    ``seconds`` have passed; each step is enqueued before the one before it
    is waited for. Returns ``(steps, elapsed seconds, [loss tensors])``;
    every step enqueued has finished and is counted."""
    ctx = P.span if spans else (lambda name: contextlib.nullcontext())
    losses, done, i, pending = [], 0, start, None
    t0 = time.perf_counter()
    while True:
        with ctx("feed"):
            batch = feed(i)
        with ctx("train_step"):
            losses.append(program.step(batch))
        ev = _event(device)
        i += 1
        if pending is not None:
            with ctx("sync"):
                _wait(pending)
            done += 1
        pending = ev
        if (count is not None and i - start >= count) or (
                seconds is not None and done
                and time.perf_counter() - t0 >= seconds):
            break
    with ctx("sync"):
        _wait(pending)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return done + 1, time.perf_counter() - t0, losses


@torch.no_grad()
def program_readings(program, cell, seed, device, losses, grad):
    """The program's side of the comparison from its own state after the
    checked steps (``grad``: the first gradient's norms, read after the
    first)."""
    stacked = W.stacked_paths(program.specs)
    change = {}
    for path, p0 in W.iter_weights(program.specs, seed, device):
        d = _at(program.params, path).float() - p0.float()
        del p0
        change.update(check.norms(check.layer_slices([(path, d)], stacked)))
        del d
    faults = 0
    moment_type = {"float32": torch.float32,
                   "bfloat16": torch.bfloat16}.get(
        cell.config["training"]["moments"])
    for path, s in W.spec_leaves(program.specs):
        faults += _at(program.params, path).dtype != s.dtype
        for which in ("m", "v"):
            node = _at(program.opt[which], path)
            faults += isinstance(node, dict) or node.dtype != moment_type
    return {"losses": [float(x) for x in losses], "grad": grad,
            "change": change, "dtype_faults": int(faults)}


@torch.no_grad()
def first_grad_norms(program, b1: float) -> dict:
    """The first gradient's norms as the optimizer took it, from the first
    moment after one step (``m_1 / (1 - b1)``), leaf by leaf."""
    stacked = W.stacked_paths(program.specs)
    out = {}
    for path, _ in W.spec_leaves(program.specs):
        m = _moment32(_at(program.opt["m"], path))
        out.update(check.norms(check.layer_slices([(path, m)], stacked),
                               1.0 / (1.0 - b1)))
    return out


def checked_steps(program, cell, seed, feed, device, k: int):
    """Steps ``0..k-1`` of the program from the seed, and its readings."""
    losses, grad = [], None
    for i in range(k):
        losses.append(program.step(feed(i)))
        if i == 0:
            grad = first_grad_norms(program, cell.config["training"]["b1"])
    return program_readings(program, cell, seed, device, losses, grad)


def reference_readings(cell, specs, seed, device, k: int):
    """The reference's side: from the seed's weights (float32 copies),
    through the same ``k`` batches."""
    from bench.reference import common
    ref = cell.reference()
    common.exact_float32()
    stacked = W.stacked_paths(specs)
    leaves, store = {}, {}
    for path, t in W.iter_weights(specs, seed, device):
        t32 = t.float()
        del t
        for key, sl in check.layer_slices([(path, t32)], stacked).items():
            leaves[key] = sl.clone() if key[1] is not None else sl
            store[key] = _at(specs, path).dtype
        del t32
    tokens = TokenFeed.from_traffic(cell.spec["traffic"],
                                    cell.config["vocab_size"], seed)
    feed = Feed(tokens, device)
    batches = [(b["tokens"], b["labels"]) for b in map(feed, range(k))]
    cfg = cell.config
    losses, grad = common.follow(
        lambda lv, tok, lab: ref.loss(lv, cfg, tok, lab), leaves, batches,
        cell.config["training"], store)
    change = {}
    with torch.no_grad():
        for path, p0 in W.iter_weights(specs, seed, device):
            p0 = p0.float()
            for key, sl in check.layer_slices([(path, p0)], stacked).items():
                change[key] = float(torch.linalg.vector_norm(leaves[key] - sl))
            del p0
    return {"losses": losses, "grad": grad, "change": change}


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, variant: str | None = None) -> dict:
    """One run of a training cell; returns the result line's object."""
    device = torch.device(device or "cuda")
    spec = cell.spec
    k = spec["checked_steps"]
    tokens = TokenFeed.from_traffic(spec["traffic"],
                                    cell.config["vocab_size"], seed)
    feed = Feed(tokens, device)
    t = time.perf_counter()
    program = Program(cell, seed, device, variant)
    log(f"weights and optimizer state: {time.perf_counter() - t!r} s")
    t = time.perf_counter()
    prog = checked_steps(program, cell, seed, feed, device, k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"{k} checked steps and their readings: {time.perf_counter() - t!r} s;"
        f" losses {prog['losses']}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    steps, elapsed, losses = run_steps(program, feed, device, k,
                                       seconds=seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tokens_a_step = spec["traffic"]["batch"] * spec["traffic"]["seq"]
    rate = steps * tokens_a_step / elapsed
    nonfinite = int((~torch.isfinite(torch.stack(losses).float())).sum())
    log(f"window: {steps} steps in {elapsed!r} s, {rate!r} tokens/s, peak "
        f"{peak} bytes, setup {setup_s!r} s")
    prog["nonfinite"] = nonfinite

    e2e = {"train_tokens_per_s": (rate, "tokens/s"),
           "peak_mem_gib": (peak / GIB, "GiB"), "setup_s": (setup_s, "s")}
    metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]}
               for m in cell.end_to_end()}
    device_info = _device_info(device, cell.chips, peak)
    extra = {}
    if trace:
        metrics, dev_trace, extra = _traced(program, cell, feed, device,
                                            k + steps, rate)
        device_info["busy_s"] = P.busy_ns(dev_trace) / 1e9
        device_info["window_s"] = dev_trace.window_s

    specs = program.specs
    program.free()
    del program, losses
    free_device()
    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ref = reference_readings(cell, specs, seed, device, k)
    ref_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    log(f"reference, {k} steps: {time.perf_counter() - t!r} s, peak "
        f"{ref_peak} bytes; losses {ref['losses']}")
    values = check.readings(prog, ref)
    log(f"worst leaves: {values['_where']}; all readings: "
        f"{ {k: v for k, v in values.items() if k != '_where'} }")
    correct, checks = check.judge(values, spec["limits"])
    out = {"correct": correct, "attempted": steps, "failed": nonfinite,
           "metrics": metrics, "device": device_info}
    out.update(extra)
    out["checks"] = checks
    return out


def _device_info(device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def _traced(program, cell, feed, device, start: int, rate: float):
    """The per-layer metrics from ``trace_steps`` steps under the
    profiler."""
    from repro_torch.kernels import flash_attention as fa
    n = cell.spec["trace_steps"]
    before = (fa.flash_attention_kernel.launches,
              fa.flash_attention_backward_kernel.launches)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with P.traced() as prof:
        with P.span("window"):
            steps, elapsed, _ = run_steps(program, feed, device, start,
                                          count=n, spans=True)
    t = time.perf_counter()
    dev_trace = P.reduce(prof, n)
    del prof
    tb = cell.spec["traffic"]
    log(f"traced window: {n} steps in {elapsed!r} s under the profiler "
        f"({n * tb['batch'] * tb['seq'] / elapsed!r} tokens/s against "
        f"{rate!r} untraced); {len(dev_trace.kernels)} kernels; reduced in "
        f"{time.perf_counter() - t!r} s")
    ctx = Context(cell, program, dev_trace, rate, {
        "flash_fwd_launches": fa.flash_attention_kernel.launches - before[0],
        "flash_bwd_launches":
            fa.flash_attention_backward_kernel.launches - before[1]})
    metrics = {}
    for m in cell.per_layer():
        value = cell.reader(m["name"])(ctx)
        log(f"per-layer {m['name']}: {value!r}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, dev_trace, {"breakdown": P.breakdown(dev_trace)}


class Context:
    """What a per-layer reader reads: the traced window (``trace``), the
    program's counters over it, the untraced window's rate, the cell's
    shapes and the family's counts."""

    def __init__(self, cell, program, trace, tokens_per_s: float,
                 counters: dict):
        tb = cell.spec["traffic"]
        self.cell, self.trace, self.counters = cell, trace, counters
        self.steps = trace.steps
        self.tokens_per_s = tokens_per_s
        self.batch, self.seq = tb["batch"], tb["seq"]
        self.flops_per_token = cell.family.model_flops_per_token(
            cell.config, self.seq)
        self.flash_calls = cell.family.flash_calls(cell.config, program.port,
                                                   self.batch, self.seq)
        self.peaks = peaks
        self.profile = P
        self.log = log
