"""The training step's profiler ranges (``repro_torch.obs.profile_range``) on
the CPU: none is entered without a profiler, a profiler leaves the step's
numbers bit for bit as they are, and each span opens as often as the model
runs its code in each pass, at smoke size (two GQA layers, ``remat="full"``,
the CE in four chunks)."""
import dataclasses
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.specs import materialize, tree_leaves  # noqa: E402
from repro_torch.obs import recorder  # noqa: E402
from repro_torch.train.optim import AdamWConfig  # noqa: E402
from repro_torch.train.step import (TrainConfig, init_optimizer,  # noqa: E402
                                    make_train_step)

SEQ, CHUNK = 32, 8
CHUNKS = SEQ // CHUNK


def _cfg():
    return dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                               remat="full", logit_chunk=CHUNK)


def _setup(seed=0):
    cfg = _cfg()
    params = materialize(lm.lm_specs(cfg), torch.Generator().manual_seed(seed),
                         device="cpu")
    tcfg = TrainConfig(adam=AdamWConfig(lr=1e-3, grad_clip=1.0))
    step = make_train_step(
        lambda p, b: lm.lm_loss(p, cfg, b["tokens"], b["labels"]), tcfg)
    tok = torch.randint(0, cfg.vocab, (2, SEQ + 1),
                        generator=torch.Generator().manual_seed(seed + 1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    return cfg, params, init_optimizer(params, tcfg), step, batch


class _Counting:
    """A stand-in for the op-scope record that counts its entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


def test_no_range_entered_without_profiler(monkeypatch):
    monkeypatch.setattr(recorder, "_RecordFunctionFast", _Counting)
    _Counting.entered = 0
    _, params, opt, step, batch = _setup()
    step(params, opt, batch)
    assert _Counting.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, opt, batch)
    assert _Counting.entered > 0


def _state(params, opt, losses):
    leaves = [t for _, t in tree_leaves(params)]
    leaves += [t for _, t in tree_leaves(opt["m"])]
    leaves += [t for _, t in tree_leaves(opt["v"])]
    return [t.detach().clone() for t in leaves] + list(losses)


def test_profiler_leaves_the_step_bit_identical():
    runs = []
    for traced in (False, True):
        _, params, opt, step, batch = _setup()
        losses = []
        for _ in range(2):
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    params, opt, m = step(params, opt, batch)
            else:
                params, opt, m = step(params, opt, batch)
            losses.append(m["loss"].detach().clone())
        runs.append(_state(params, opt, losses))
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _events():
    cfg, params, opt, step, batch = _setup()
    step(params, opt, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, batch)
    return cfg, list(prof.profiler.kineto_results.events())


def test_span_counts_per_pass():
    cfg, events = _events()
    ranges = [e for e in events if e.name().startswith("repro_torch.")]
    assert ranges
    (bwd,) = [e for e in ranges if e.name() == "repro_torch.train.backward"]
    (fwd,) = [e for e in ranges if e.name() == "repro_torch.train.forward"]

    def inside(e, span):
        return span.start_ns() <= e.start_ns() < (span.start_ns()
                                                  + span.duration_ns())

    passes = Counter()
    for e in ranges:
        p = ("backward" if inside(e, bwd) else
             "forward" if inside(e, fwd) else "outside")
        passes[(e.name()[len("repro_torch."):], p)] += 1
    n = cfg.n_layers
    want = {
        ("model.norm", "forward"): 2 * n + 1,       # two a layer, the final
        ("model.norm", "backward"): 2 * n,         # recomputed layers only
        ("model.layer", "forward"): n, ("model.layer", "backward"): n,
        ("model.rope", "forward"): 2 * n, ("model.rope", "backward"): 2 * n,
        ("model.swiglu", "forward"): n, ("model.swiglu", "backward"): n,
        ("model.layer_params", "forward"): n,
        ("model.ce_chunk", "forward"): CHUNKS,
        ("model.ce_chunk", "backward"): CHUNKS,
        ("model.ce", "forward"): CHUNKS, ("model.ce", "backward"): CHUNKS,
        ("optim.adamw", "outside"): 1, ("train.step", "outside"): 1,
        ("train.forward", "forward"): 1, ("train.backward", "backward"): 1,
    }
    assert dict(passes) == want


def test_ranges_are_not_user_annotations():
    """A user annotation would be mirrored onto the device's timeline as
    an event of its own; the program's ranges are op-scope records."""
    _, events = _events()
    ranges = [e for e in events if e.name().startswith("repro_torch.")]
    assert ranges
    for e in ranges:
        assert not e.is_user_annotation(), e.name()
        assert e.sequence_nr() == -1, e.name()
