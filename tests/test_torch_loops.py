"""The models' loops folded in a dry run's trace (``repro_torch.models.loop``
under ``core.trace_analysis.TraceRecorder(fold=True)``) against the same
step traced unrolled, on the CPU over an 8-rank world of the ``fake``
backend (a ``(2, 4)`` mesh), at cut widths with at least four trips a loop.

For every loop site (the layer stacks, a hybrid segment's periods and the
layers inside them, the chunked cross-entropy, Mamba2's inter-chunk
recurrence, the xLSTM chunks and the steps inside them, the enc-dec
stacks, the chunked attention's kv blocks forward and backward, microbatch
accumulation) and every kind of step it runs in: FLOPs, matrix products,
bytes and every collective figure (by kind, by link, by mesh axis) are
exactly the unrolled trace's; the peak per device is within 2%. The
reference's ``test_scan_flops_multiplied_by_trip_count`` folded, and a
training step on real tensors unchanged by a folding recorder.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.configs.registry import (ShapeSpec,  # noqa: E402
                                          get_smoke_config)
from repro_torch.core import trace_analysis as TA  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import loop  # noqa: E402
from repro_torch.models.lm import Segment  # noqa: E402

PEAK_TOL = 0.02


@pytest.fixture(scope="module")
def fake_world():
    """An 8-rank world of the fake backend, rank 0; destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cfg(arch, kind="train"):
    """The smoke config and a sequence length that give every loop four
    trips or more: four layers (for zamba2 in periods of one layer and the
    shared block; for the xLSTM an mLSTM and an sLSTM layer, whose loops
    are their chunks and the sLSTM's steps, the sLSTM alone in training,
    where both run the same checkpointed chunk loop), the CE in chunks of
    8 tokens, the SSD in chunks of 8 and the xLSTM in chunks of 4 steps."""
    cfg = get_smoke_config(arch)
    if arch == "seamless-m4t-medium":
        return dataclasses.replace(cfg, n_enc_layers=4, n_dec_layers=4,
                                   logit_chunk=8, k_chunk=1024), 64
    if arch == "zamba2-2.7b":
        return dataclasses.replace(
            cfg, segments=(Segment("mamba2", "none", 4),), hybrid_period=1,
            logit_chunk=8, ssm=dataclasses.replace(cfg.ssm, chunk=8)), 32
    if arch == "xlstm-125m":
        segs = (Segment("mlstm", "none", 1), Segment("slstm", "none", 1))
        return dataclasses.replace(
            cfg, segments=segs[1:] if kind == "train" else segs,
            xlstm=dataclasses.replace(cfg.xlstm, chunk=4)), 16
    seg = cfg.segments[0]
    return dataclasses.replace(
        cfg, segments=(Segment(seg.kind, seg.mlp, 4),), logit_chunk=8), 32


def _figures(cell, fold):
    trace, memory = cell.trace(fold=fold)
    st = TA.analyze_trace(trace)
    return trace, {
        "flops": st["flops"], "bytes": st["bytes"], "n_dots": st["n_dots"],
        "collectives": st["collectives"],
        "by_link": D.collective_links(trace),
        "by_axis": D.collective_axes(trace, cell.mesh),
        "peak": memory["peak_bytes_per_device"]}


def _assert_folded_equals_unrolled(make_cell):
    unrolled, want = _figures(make_cell(), False)
    folded, got = _figures(make_cell(), True)
    assert len(folded.ops) < len(unrolled.ops)
    assert folded.n_unrolled >= len(folded.ops)
    for key in ("flops", "n_dots", "bytes", "collectives", "by_link",
                "by_axis"):
        assert got[key] == want[key], key
    assert got["peak"] == pytest.approx(want["peak"], rel=PEAK_TOL)
    return unrolled, folded


CELLS = [("internlm2-1.8b", "train"), ("internlm2-1.8b", "prefill"),
         ("internlm2-1.8b", "decode"), ("zamba2-2.7b", "train"),
         ("zamba2-2.7b", "prefill"), ("zamba2-2.7b", "decode"),
         ("xlstm-125m", "train"), ("xlstm-125m", "prefill"),
         ("seamless-m4t-medium", "train"),
         ("seamless-m4t-medium", "prefill"),
         ("seamless-m4t-medium", "decode")]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_folded_cell_equals_the_unrolled_trace(fake_world, arch, kind):
    """Each loop site in each kind of step it runs in: the layer stacks
    (internlm2, every kind), the CE chunks (train), zamba2's periods (a
    layer and the shared block) and the SSD's inter-chunk recurrence
    (train, prefill), the xLSTM's chunks x steps (sLSTM; train, prefill)
    and chunks (mLSTM; prefill), the enc-dec stacks, and decode's
    cross-attention over a cell's 4096 source frames in kv blocks of 1024
    (``_Flash`` forward)."""
    cfg, seq = _cfg(arch, kind)
    shape = ShapeSpec("x", seq, 8, kind)
    mesh = make_test_mesh((2, 4))
    _assert_folded_equals_unrolled(
        lambda: build_cell(arch, shape, mesh, cfg=cfg))


def test_folded_microbatches_equal_the_unrolled_trace(fake_world):
    """Microbatch accumulation (``train.step``, 4 microbatches of 2 rows,
    one layer): each microbatch's own backward inside the folded
    iteration counts once a trip."""
    from repro_torch.models import lm
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.sharding import rules as R
    cfg = dataclasses.replace(_cfg("internlm2-1.8b")[0], segments=(
        Segment("attn", "dense", 1),))
    mesh = make_test_mesh((2, 4))
    step = make_train_step(
        lambda p, bt: lm.lm_loss(p, cfg, bt["tokens"], bt["labels"]),
        TrainConfig(accum_steps=4))

    def make():
        cell = build_cell("internlm2-1.8b", ShapeSpec("x", 32, 8, "train"),
                          mesh, cfg=cfg)

        def run(params, opt, batch):
            with R.set_context(mesh):
                return step(params, opt, batch)
        return dataclasses.replace(cell, step_fn=run)
    _assert_folded_equals_unrolled(make)


def test_folded_flash_blocks_equal_the_unrolled_trace(fake_world):
    """``_Flash``'s kv blocks, forward and backward (its backward runs the
    folded loop inside autograd's): one q chunk of 64 over 64 keys in
    blocks of 16, causal, with a gradient."""
    figures = []
    for fold in (False, True):
        fm = FakeTensorMode()
        with fm:
            q, k, v = (torch.empty(2, 64, 4, 16, requires_grad=True)
                       for _ in range(3))
        rec = TA.TraceRecorder(fm, fold=fold)
        with rec:
            out = L._Flash.apply(q, k, v, 0, 0, None, True, 16)
            torch.autograd.grad(out.sum(), [q, k, v])
        st = TA.analyze_trace(rec.trace())
        figures.append((st["flops"], st["n_dots"], st["bytes"],
                        len(rec.ops)))
    (f0, d0, b0, n0), (f1, d1, b1, n1) = figures
    assert (f1, d1, b1) == (f0, d0, b0) and n1 < n0


def test_five_matmul_loop_folded_counts_per_device(fake_world):
    """``test_five_matmul_loop_counts_per_device`` through ``loop.scan``
    under a folding recorder, the reference's
    ``test_scan_flops_multiplied_by_trip_count``: the first and last of
    the 5 trips traced, the middle one for 3; 5 x 2 x 16 x 16 x 64 FLOPs a
    device, 5 dots, and the collectives DTensor issues
    (``CommDebugMode``'s counts on the unrolled loop)."""
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = make_test_mesh((2, 4))
    fm = FakeTensorMode()
    with fm:
        x = DTensor.from_local(torch.empty(16, 64), mesh,
                               [Shard(0), Replicate()], run_check=False)
        ws = DTensor.from_local(torch.empty(5, 64, 16), mesh,
                                [Replicate(), Shard(2)], run_check=False)

    def f():
        h, _ = loop.scan(lambda h, i: (h @ ws[i], None), x, 5)
        return h.sum()

    rec = TA.TraceRecorder(fm, fold=True)
    with rec:
        f()
    res = TA.analyze_trace(rec.trace())
    assert res["flops"] == 5 * 2 * 16 * 16 * 64
    assert res["n_dots"] == 5
    assert res["unknown_trip_whiles"] == 0
    dots = [op for op in rec.ops if TA.dot_flops(op)]
    assert sorted(op.count for op in dots) == [1, 1, 3]
    comm = CommDebugMode()
    with fm, comm:
        f()
    names = {"all_reduce": "all-reduce", "all_gather_into_tensor":
             "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
    want = {}
    for op, n in comm.get_comm_counts().items():
        kind = names[str(op).split(".")[1]]
        want[kind] = want.get(kind, 0) + n
    got = {k: v["count"] for k, v in res["collectives"]["by_kind"].items()}
    assert got == want


def _python_loop(body, carry, n):
    """The loops as the models ran them before ``loop.scan``."""
    ys = []
    for i in range(n):
        carry, y = body(carry, i)
        ys.append(y)
    return carry, ys


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_real_step_is_unchanged_by_a_folding_recorder(arch, monkeypatch):
    """One smoke training step on real CPU tensors, its loops of four or
    more trips, run twice: with every module's ``scan`` a plain Python
    loop (and ``recomputed`` the identity), and with ``loop.scan`` under
    a folding recorder, where no loop may see a folder (a recorder folds
    only on fake tensors). The loss and every gradient are bit-identical.
    What the loops compute against the reference is held by the JAX-held
    losses and gradients of ``test_torch_train.py``."""
    from repro_torch.models import encdec, lm, mamba2, xlstm
    from repro_torch.models.specs import materialize, tree_leaves
    from repro_torch.train import step
    modules = (L, encdec, lm, mamba2, xlstm, step)
    cfg, seq = _cfg(arch)
    gen = torch.Generator().manual_seed(0)
    tok, lab = (torch.randint(0, cfg.vocab, (2, seq), generator=gen)
                for _ in range(2))
    calls = []

    def probed(body, carry, n):
        calls.append(loop._folder)
        return loop.scan(body, carry, n)

    def run():
        params = materialize(lm.lm_specs(cfg),
                             torch.Generator().manual_seed(1), device="cpu")
        leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
        loss = lm.lm_loss(params, cfg, tok, lab)[0]
        return loss, torch.autograd.grad(loss, leaves)

    with monkeypatch.context() as m:
        for mod in modules:
            m.setattr(mod, "scan", _python_loop)
        for mod in (lm, xlstm):
            m.setattr(mod, "recomputed", lambda fn: fn)
        l0, g0 = run()
    rec = TA.TraceRecorder(None, fold=True)
    with monkeypatch.context() as m:
        for mod in modules:
            m.setattr(mod, "scan", probed)
        with rec:
            l1, g1 = run()
    assert calls and all(f is None for f in calls)
    assert rec.trace().n_unrolled == len(rec.ops) > 0
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
