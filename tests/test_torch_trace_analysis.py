"""The op-trace cost analysis (``repro_torch.core.trace_analysis``)
against the reference's HLO walker (``repro.core.hlo_analysis``), on the
CPU over worlds of the ``fake`` backend (no process plays the other
ranks).

Exact: each recorded collective's operand and wire bytes equal
``analyze_hlo``'s on a one-instruction HLO module of the same kind, shape
and group size (5 kinds x group sizes 2, 4, 16); the reference test's loop
of five matmuls counts ``5 * 2 * 16 * 16 * 64`` FLOPs a device on a 2 x 4
mesh with the same layouts, and its collectives are the ones DTensor
issues (``CommDebugMode``'s counts); the flash ops count 4 D (forward) and
10 D (backward) FLOPs per visible pair and head. A smoke train cell's
per-device FLOPs equal the reference walker's on the reference's own cell
(8 host devices, a subprocess) on ``(8, 1)`` and ``(2, 4)`` meshes, and
its decode cell's on ``(2, 4)``, once attention is counted the reference's
way: its dense 64 x 64 block computes every (q, k) pair, where the port's
kernel counts the visible ones, and its backward's rowsum(dO * O) is a dot
(2 S D a head) inside the port's kernel.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed import _functional_collectives as funcol  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.core.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch.core import trace_analysis as TA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# what remains of the xLSTM cells' FLOP gap to the reference walker once
# the differences that are known are itemised (read on torch 2.13, CPU:
# 2.41e-3 and 1.84e-4)
XLSTM_SMOKE_REL = 2.5e-3
XLSTM_CUT_REL = 2e-4


@pytest.fixture
def fake_world():
    """A 16-rank world of the fake backend, rank 0; destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _hlo(kind, group, n=16):
    """A one-instruction module: ``kind`` of an f32[16,16] parameter over
    groups of ``group`` of ``n`` devices."""
    out = {"all-gather": f"f32[{16 * group},16]",
           "reduce-scatter": f"f32[{16 // group},16]"}.get(kind, "f32[16,16]")
    groups = f"replica_groups=[{n // group},{group}]<=[{n}]"
    attrs = {"all-gather": f"{groups}, dimensions={{0}}",
             "reduce-scatter": f"{groups}, dimensions={{0}}, to_apply=%add",
             "all-reduce": f"{groups}, to_apply=%add",
             "all-to-all": f"{groups}, dimensions={{0}}",
             "collective-permute": "source_target_pairs={{0,1},{1,0}}"}[kind]
    return (f"HloModule test, is_scheduled=true\n\n"
            f"ENTRY %main (a: f32[16,16]) -> {out} {{\n"
            f"  %a = f32[16,16] parameter(0)\n"
            f"  ROOT %c = {out} {kind}(%a), {attrs}\n}}\n")


KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("group", (2, 4, 16))
@pytest.mark.parametrize("kind", KINDS)
def test_collective_bytes_equal_the_reference_model(fake_world, kind, group):
    pg = dist.new_group(list(range(group)))
    fm = FakeTensorMode()
    with fm:
        x = torch.empty(16, 16)
    rec = TA.TraceRecorder(fm)
    with rec:
        if kind == "all-reduce":
            funcol.all_reduce(x, "sum", pg)
        elif kind == "all-gather":
            funcol.all_gather_tensor(x, 0, pg)
        elif kind == "reduce-scatter":
            funcol.reduce_scatter_tensor(x, "sum", 0, pg)
        elif kind == "all-to-all":
            funcol.all_to_all_single(x, None, None, pg)
        else:
            funcol.permute_tensor(x, [(i + 1) % group for i in range(group)],
                                  pg)
    ops = [op for op in rec.ops if "kind" in op.attrs]
    assert len(ops) == 1 and ops[0].attrs["kind"] == kind
    assert ops[0].attrs["group_size"] == group
    assert ops[0].attrs["group_ranks"] == tuple(range(group))
    got = TA.analyze_trace(rec.trace())["collectives"]
    want = analyze_hlo(_hlo(kind, group))["collectives"]
    assert got["by_kind"][kind] == want["by_kind"][kind]
    for key in ("operand_bytes", "wire_bytes", "n_ops"):
        assert got[key] == want[key], key


def test_five_matmul_loop_counts_per_device(fake_world):
    """The reference's ``test_scan_flops_multiplied_by_trip_count`` on a
    2 x 4 mesh: x [32, 64] over data, ws [5, 64, 64] over model on the
    last dim; per device 5 x 2 x 16 x 16 x 64 FLOPs."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 4))
    fm = FakeTensorMode()
    with fm:
        x = DTensor.from_local(torch.empty(16, 64), mesh,
                               [Shard(0), Replicate()], run_check=False)
        ws = DTensor.from_local(torch.empty(5, 64, 16), mesh,
                                [Replicate(), Shard(2)], run_check=False)

    def f():
        h = x
        for i in range(5):
            h = h @ ws[i]
        return h.sum()

    rec = TA.TraceRecorder(fm)
    with rec:
        f()
    res = TA.analyze_trace(rec.trace())
    assert res["flops"] == 5 * 2 * 16 * 16 * 64
    assert res["n_dots"] == 5
    assert res["unknown_trip_whiles"] == 0
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
    assert got.get("all-gather", 0) >= 4        # h gathered over model


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_flash_ops_count_visible_pairs(causal, window):
    fm = FakeTensorMode()
    b, h, hkv, s, d = 2, 4, 2, 40, 32
    with fm:
        q = torch.empty(b, h, s, d, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(b, hkv, s, d, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(b, h, s, device="cuda")
    before = (FA.flash_attention_kernel.launches,
              FA.flash_attention_backward_kernel.launches)
    rec = TA.TraceRecorder(fm)
    with fm, rec:            # the mode too: a CUDA factory needs it here
        o = FA.flash_attention_kernel(q, k, k, causal=causal, window=window,
                                      lse=lse)
        dq, dk, dv = FA.flash_attention_backward_kernel(
            q, k, k, o, o, lse, causal=causal, window=window)
    assert (FA.flash_attention_kernel.launches,
            FA.flash_attention_backward_kernel.launches) == before
    assert o.shape == q.shape and o.dtype == q.dtype
    assert dk.shape == k.shape and dq.shape == q.shape
    flash = [op for op in rec.ops if op.name.startswith("repro_torch.")]
    assert [op.base for op in flash] == ["flash_attention",
                                         "flash_attention_backward"]
    pairs = FA.visible_pairs(s, causal, window)
    assert TA.flash_flops(flash[0]) == 4 * d * pairs * b * h
    assert TA.flash_flops(flash[1]) == 10 * d * pairs * b * h
    assert TA.analyze_trace(rec.trace())["flops"] == 14 * d * pairs * b * h


REF_INTERNLM2 = """
import os, sys, json
sys.path.insert(0, SRC)
from repro.configs import registry as R
from repro.launch.cells import build_cell
from repro.launch.mesh import make_test_mesh
from repro.core.hlo_analysis import analyze_hlo
out = {}
for kind, mesh in (("train", (8, 1)), ("train", (2, 4)), ("decode", (2, 4))):
    R.SHAPES["tiny"] = R.ShapeSpec("tiny", 64, 8, kind)
    cell = build_cell("internlm2-1.8b", "tiny", make_test_mesh(mesh),
                      cfg=R.get_smoke_config("internlm2-1.8b"))
    out[f"{kind}-{mesh}"] = analyze_hlo(
        cell.lower().compile().as_text())["flops"]
print(json.dumps(out))
"""


def _reference(code):
    """The last line of ``code``'s output, JSON, run with the reference on
    8 host devices (a subprocess)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", f"SRC = {SRC!r}\n"
                          + textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_internlm2():
    """The reference walker's FLOPs a device of internlm2's smoke train
    cell on ``(8, 1)`` and ``(2, 4)`` meshes and of its decode cell on
    ``(2, 4)``."""
    return _reference(REF_INTERNLM2)


def _internlm2_cell(kind, mesh):
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        cell = build_cell("internlm2-1.8b", ShapeSpec("tiny", 64, 8, kind),
                          make_test_mesh(mesh),
                          cfg=get_smoke_config("internlm2-1.8b"))
        return cell.trace()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh,heads", [((8, 1), (4, 2)), ((2, 4), (1, 1))],
                         ids=["8x1", "2x4"])
def test_smoke_train_cell_flops_equal_the_reference_walker(ref_internlm2,
                                                           mesh, heads):
    """internlm2's smoke train cell (4 query heads, 2 kv heads, 8 x 64
    tokens): FLOPs a device equal to the reference walker's on the
    reference's own cell, with attention counted its way. On ``(2, 4)``
    the 2 kv heads do not divide the model axis of 4: the reference
    repeats K/V (``repeat_kv``) and its scores shard over the query heads;
    the port's ranks take the kv head their own query head reads,
    projected from their slice of ``wk``/``wv``, so every flash op takes
    one query head and one kv head a rank (``heads``), and the K/V
    projections run on one head a rank as the reference's do."""
    trace, memory = _internlm2_cell("train", mesh)
    res = TA.analyze_trace(trace)
    flash = [op for op in trace.ops if TA.flash_flops(op)]
    assert [op.base for op in flash] == ["flash_attention"] * 2 + [
        "flash_attention_backward"] * 2
    for op in flash:
        assert (op.inputs[0][0][1], op.inputs[1][0][1]) == heads
    assert res["flops"] + _dense_attention(trace) == \
        ref_internlm2[f"train-{mesh}"]
    assert memory["peak_bytes_per_device"] > memory["argument_bytes"] > 0


def test_smoke_decode_cell_flops_equal_the_reference_walker(ref_internlm2):
    """internlm2's smoke decode cell (8 rows, a 64-row cache) on a
    ``(2, 4)`` mesh: the 2 kv heads do not divide the model axis, so the
    caches split over their sequence (``launch.cells._pick_rules``), 16
    rows a rank. The reference's masked read attends every query head
    over each rank's own rows; so does the port's (``layers._sharded_
    decode``: q gathered, the ranks' softmaxes merged by their maxima),
    where it gathered the caches and attended over all 64 rows on every
    rank: FLOPs a device equal, and no collective carries a cache."""
    trace, _ = _internlm2_cell("decode", (2, 4))
    assert TA.analyze_trace(trace)["flops"] == ref_internlm2[
        "decode-(2, 4)"]
    # the scores and the weighted sum, batched over 4 rows x 2 kv heads:
    # 16 keys a rank
    attn = [op for op in trace.ops if op.base == "bmm"
            and tuple(op.inputs[0][0][:2]) == (8, 2)]
    assert len(attn) == 4
    assert all(tuple(op.inputs[1][0][1:]) == (16, 16) for op in attn)
    for op in trace.ops:
        if "kind" in op.attrs:
            assert all(tuple(o[0])[-3:] != (64, 2, 16)
                       for o in op.outputs + op.inputs), op
REF_RECURRENT = """
import os, sys, json
sys.path.insert(0, SRC)
from repro.configs import registry as R
from repro.launch.cells import build_cell
from repro.launch.mesh import make_test_mesh
from repro.core.hlo_analysis import analyze_hlo
import dataclasses
from repro.core import hlo_analysis as H
from repro.models.lm import Segment
R.SHAPES["tiny"] = R.ShapeSpec("tiny", 64, 8, "train")
out = {}
for arch in ("zamba2-2.7b", "xlstm-125m"):
    cell = build_cell(arch, "tiny", make_test_mesh((8, 1)),
                      cfg=R.get_smoke_config(arch))
    out[arch] = analyze_hlo(cell.lower().compile().as_text())["flops"]
# the xLSTM cut on a (2, 4) mesh: its FLOPs, and those of the dots with a
# dim of the sLSTM FFN's width (outside every loop, so each counts once)
cfg = dataclasses.replace(
    R.get_config("xlstm-125m"), d_model=256, vocab=4096,
    segments=(Segment("mlstm", "none", 1), Segment("slstm", "none", 1)))
hlo = build_cell("xlstm-125m", "tiny", make_test_mesh((2, 4)),
                 cfg=cfg).lower().compile().as_text()
ffn = int(cfg.d_model * cfg.xlstm.slstm_ff)
comps, params = H._parse_computations(hlo)
ffn_flops = 0.0
for name, instrs in comps.items():
    symtab = {i.name: i.out_sig for i in instrs}
    for pn, sig in params.get(name, []):
        symtab.setdefault(pn, sig)
    for ins in instrs:
        sigs = [ins.out_sig] + [symtab.get(o, "") for o in ins.operands]
        if ins.op == "dot" and any(ffn in dims for sig in sigs
                                   for _, dims in H._shape_list(sig)):
            ffn_flops += H._dot_flops(ins, symtab)
out["xlstm-cut"] = {"flops": analyze_hlo(hlo)["flops"], "ffn": ffn_flops}
# the cut on a (1, 8) mesh at 2 and 3 rows: its FLOPs, and those of the
# products outside the scans (the blocks' and the head's einsums, by the
# spec their dots trace from; outside every loop, so each counts once)
import re
OUTSIDE = {"bsd,de->bse", "bse,ehk->bshk", "bse,ehg->bshg", "bse,ed->bsd",
           "bsd,dhg->bshg", "bsd,df->bsf", "bsf,fd->bsd", "bsd,dv->bsv"}
for rows in (2, 3):
    R.SHAPES["tiny"] = R.ShapeSpec("tiny", 64, rows, "train")
    hlo = build_cell("xlstm-125m", "tiny", make_test_mesh((1, 8)),
                     cfg=cfg).lower().compile().as_text()
    comps, params = H._parse_computations(hlo)
    outside = 0.0
    for name, instrs in comps.items():
        symtab = {i.name: i.out_sig for i in instrs}
        for pn, sig in params.get(name, []):
            symtab.setdefault(pn, sig)
        for ins in instrs:
            m = re.search(r'op_name="([^"]*)"', ins.raw)
            specs = re.findall(r"[a-z]+(?:,[a-z]+)*->[a-z]+",
                               m.group(1) if m else "")
            if ins.op == "dot" and specs and specs[-1] in OUTSIDE:
                outside += H._dot_flops(ins, symtab)
    out[f"xlstm-pairs-{rows}"] = {"flops": analyze_hlo(hlo)["flops"],
                                  "outside": outside}
print(json.dumps(out))
"""


def _port_smoke_cell(arch):
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        cfg = get_smoke_config(arch)
        cell = build_cell(arch, ShapeSpec("tiny", 64, 8, "train"),
                          make_test_mesh((8, 1)), cfg=cfg)
        trace, _ = cell.trace()
    finally:
        dist.destroy_process_group()
    return cfg, trace


def _dense_attention(trace):
    """The flash ops' FLOPs counted the reference's way (its dense block
    computes every (q, k) pair; its backward's rowsum(dO * O) is a dot),
    less the port's count."""
    dense = 0.0
    for op in trace.ops:
        if not TA.flash_flops(op):
            continue
        b, h, s, d = op.inputs[0][0]
        per = 4 * d * s * s if op.base == "flash_attention" else (
            10 * d * s * s + 2 * s * d)
        dense += (per * b * h - TA.flash_flops(op)) * op.count
    return dense


@pytest.fixture(scope="module")
def ref_recurrent():
    """The reference walker's FLOPs a device of zamba2's and xlstm's smoke
    train cells and of the xLSTM cuts, on 8 host devices (one
    subprocess)."""
    return _reference(REF_RECURRENT)


def test_smoke_zamba2_cell_flops_equal_the_reference_walker(ref_recurrent):
    """zamba2-2.7b's smoke train cell (4 Mamba2 layers in periods of 2,
    the shared attention block twice, 8 x 64 tokens on an (8, 1) mesh):
    the port's FLOPs a device equal the reference walker's on the
    reference's own cell once two things are counted the reference's
    way. Attention, as in
    ``test_smoke_train_cell_flops_equal_the_reference_walker``. And the
    SSD: in the backward of its two three-operand einsums over the
    chunked layout (``bclh,bclhn,bclhp->bchpn`` and
    ``bclh,bclhn,bchpn->bclhp``), the gradient of the per-position decay
    ends in a product over the state dim ``N`` of two ``[B, nc, L, H,
    N]`` tensors that XLA runs as a dot (``2 B nc L H N`` FLOPs) and torch
    as a multiply and a sum (elementwise, not counted): two a layer."""
    cfg, trace = _port_smoke_cell("zamba2-2.7b")
    ssm = cfg.ssm
    heads = cfg.d_model * ssm.expand // ssm.head_dim
    b_local, nc = 8 // 8, 64 // ssm.chunk
    decay_dots = cfg.n_layers * 2 * (2 * b_local * nc * ssm.chunk * heads
                                     * ssm.d_state)
    port = TA.analyze_trace(trace)["flops"]
    assert port + _dense_attention(trace) + decay_dots == \
        ref_recurrent["zamba2-2.7b"]


def _outer_flops(trace):
    """FLOPs of the trace's matrix products over a contracted dim of size
    1 (outer products), which XLA runs as multiplies."""
    def contracted(op):
        lhs = op.inputs[1] if op.base in ("addmm", "baddbmm") else \
            op.inputs[0]
        return lhs[0][-1]
    return sum(TA.dot_flops(op) * op.count for op in trace.ops
               if TA.dot_flops(op) and contracted(op) == 1)


def test_smoke_xlstm_cell_flops_match_the_reference_walker(ref_recurrent):
    """xlstm-125m's smoke train cell (5 mLSTM and 2 sLSTM layers, chunks
    of 16 steps, 8 x 64 tokens on an (8, 1) mesh) against the reference
    walker on the reference's own cell. Itemised: the port's matrix
    products over a contracted dim of size 1 (outer products: each sLSTM
    step's recurrent-weight gradient, the mLSTM's normaliser terms), which
    XLA runs as multiplies; and the mLSTM denominator's ``sum(w * scores)``
    over a chunk, which the port runs as a multiply and a sum and XLA as a
    dot (``2 B H L L`` FLOPs a chunk, forward and rematerialised). What
    remains is in the mLSTM's chunk products: XLA unrolls the 4-trip
    chunk loop, folds the products against the zero initial state and
    pairs the three-operand contractions its own way; it is not itemised
    yet and is held within ``XLSTM_SMOKE_REL`` of the reference's count
    (0.241% on this cell)."""
    cfg, trace = _port_smoke_cell("xlstm-125m")
    outer = _outer_flops(trace)
    x = cfg.xlstm
    n_mlstm = sum(s.count for s in cfg.segments if s.kind == "mlstm")
    b_local, nc = 8 // 8, 64 // x.chunk
    den = n_mlstm * nc * 2 * (2 * b_local * x.n_heads * x.chunk * x.chunk)
    port = TA.analyze_trace(trace)["flops"] - outer + den
    print(f"xlstm smoke: port {port!r}, reference "
          f"{ref_recurrent['xlstm-125m']!r}")
    assert port == pytest.approx(ref_recurrent["xlstm-125m"],
                                 rel=XLSTM_SMOKE_REL)


def test_xlstm_cut_on_a_model_axis_flops_match_the_reference_walker(
        ref_recurrent):
    """xlstm-125m cut to d_model 256, vocab 4096 and its own mLSTM ->
    sLSTM order, 8 x 64 tokens (one chunk of 64 steps) on a (2, 4) mesh,
    its 4 heads on the model axis of 4, against the reference walker on
    the reference's own cell. Itemised: the outer products and the mLSTM
    denominator's dot, as in
    ``test_smoke_xlstm_cell_flops_match_the_reference_walker``; and the
    sLSTM FFN, whose width 341 the model axis does not divide. Of its
    nine products (three forward, six backward) the port runs all nine
    split over the model axis (DTensor splits their rows), the reference
    runs three whole on every model rank and six split over the model
    dim: twice the port's FLOPs. Each side's FFN is taken out of its
    count. What remains is within ``XLSTM_CUT_REL`` of the reference's
    count (read: 1.84e-4)."""
    import dataclasses
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import Segment
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = dataclasses.replace(
        get_config("xlstm-125m"), d_model=256, vocab=4096,
        segments=(Segment("mlstm", "none", 1), Segment("slstm", "none", 1)))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        cell = build_cell("xlstm-125m", ShapeSpec("tiny", 64, 8, "train"),
                          make_test_mesh((2, 4)), cfg=cfg)
        trace, _ = cell.trace()
    finally:
        dist.destroy_process_group()
    width = int(cfg.d_model * cfg.xlstm.slstm_ff)
    ffn = sum(TA.dot_flops(op) * op.count for op in trace.ops
              if TA.dot_flops(op) and any(
                  isinstance(i, tuple) and width in i[0] for i in op.inputs))
    ref = ref_recurrent["xlstm-cut"]
    assert 2 * ffn == ref["ffn"]
    x = cfg.xlstm
    b_local, h_local, chunk = 8 // 2, x.n_heads // 4, 64
    den = 2 * (2 * b_local * h_local * chunk * chunk)
    port = (TA.analyze_trace(trace)["flops"] - _outer_flops(trace) - ffn
            + den)
    print(f"xlstm (2, 4) cut: port {port!r}, reference "
          f"{ref['flops'] - ref['ffn']!r}")
    assert port == pytest.approx(ref["flops"] - ref["ffn"],
                                 rel=XLSTM_CUT_REL)


def _xlstm_cut_cell(mesh, rows):
    """xlstm-125m cut to d_model 256, vocab 4096 and its own mLSTM ->
    sLSTM order, ``rows`` x 64 tokens on ``mesh``: the config and its
    training step's trace."""
    import dataclasses
    from repro_torch.configs.registry import ShapeSpec, get_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import Segment
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = dataclasses.replace(
        get_config("xlstm-125m"), d_model=256, vocab=4096,
        segments=(Segment("mlstm", "none", 1), Segment("slstm", "none", 1)))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh[0] * mesh[1])
    try:
        cell = build_cell("xlstm-125m", ShapeSpec("tiny", 64, rows, "train"),
                          make_test_mesh(mesh), cfg=cfg)
        trace, _ = cell.trace()
    finally:
        dist.destroy_process_group()
    return cfg, trace


def _scan_flops(cfg, n: int, s: int = 64) -> float:
    """The FLOPs of the cut's mLSTM and sLSTM scans over ``s`` steps on
    ``n`` (row, head) pairs, forward and backward (the chunks'
    recomputation included), as ``on_local_shards`` runs them on one
    rank: one row whose heads are the pairs."""
    from repro_torch.models import xlstm as X
    x = cfg.xlstm
    dh, dh_s = int(cfg.d_model * x.up_factor) // x.n_heads, \
        cfg.d_model // x.n_heads
    fm = FakeTensorMode()
    with fm:
        q, k, v = (torch.empty(1, s, n, dh, requires_grad=True)
                   for _ in range(3))
        ig, fg = (torch.empty(1, s, n, requires_grad=True) for _ in range(2))
        wx = torch.empty(1, s, n, 4 * dh_s, requires_grad=True)
        r = torch.empty(n, dh_s, 4 * dh_s, requires_grad=True)
        bg = torch.empty(n, 4 * dh_s, requires_grad=True)
    rec = TA.TraceRecorder(fm)
    with rec:
        h, _ = X.mlstm_scan(q, k, v, ig, fg, None, x.chunk)
        h2, _ = X.slstm_scan(wx, r, bg, None, x.chunk)
        (h.sum() + h2.sum()).backward()
    return TA.analyze_trace(rec.trace())["flops"]


@pytest.mark.parametrize("rows,pairs", [(2, 1), (3, 2)])
def test_xlstm_pairs_on_a_model_axis_flops_match_the_reference_walker(
        ref_recurrent, rows, pairs):
    """The cut of ``test_xlstm_cut_on_a_model_axis_flops_match_the_
    reference_walker`` on a ``(1, 8)`` mesh, where the model axis of 8
    divides neither the rows (2 or 3) nor the 4 heads: the port splits
    the scans' (row, head) pairs, ``ceil(P / 8)`` a rank (8 pairs: one a
    rank; 12: two on ranks 0-5, none on 6 and 7), with the products into
    the scans on each rank's own pairs (``sharding.rules.on_local_
    shards``). Against the reference walker on the reference's own cell:

    * outside the scans (every block and head product) the FLOPs a device
      are equal, but for one itemised difference: GSPMD splits the
      products into the scans (q, k, v, the gates, the sLSTM's input;
      forward, input and weight gradients) over the model axis, 1/8 of
      them a rank, where the port's take its pairs' share, ``pairs / P``
      (12 pairs: 2/12 against 1/8, half a pair's products more);
    * the scans themselves: GSPMD pads the 4 heads to 8 and gives rank 0
      one head of every row (``rows`` pairs against the port's
      ``pairs``), at its own cost a pair (read: 1.58e7, where the port's
      chunk products take 2.73e7; XLA drops those of the zero initial
      state in this layout). Each side's scan FLOPs are printed, the
      port's held to ``pairs`` times its cost on one pair."""
    cfg, trace = _xlstm_cut_cell((1, 8), rows)
    x = cfg.xlstm
    n_pairs, m = rows * x.n_heads, 8
    assert pairs == -(-n_pairs // m)
    d, s = cfg.d_model, 64
    di = int(d * x.up_factor)
    per_pair = 3 * 2 * s * (3 * di * (di // x.n_heads) + 2 * di + d * d)
    scan = _scan_flops(cfg, pairs)
    assert scan == pairs * _scan_flops(cfg, 1)
    port = TA.analyze_trace(trace)["flops"]
    ref = ref_recurrent[f"xlstm-pairs-{rows}"]
    print(f"xlstm (1, 8) {rows} rows: outside the scans port "
          f"{port - scan!r}, reference {ref['outside']!r}; scans port "
          f"{scan!r} on {pairs} pairs, reference "
          f"{ref['flops'] - ref['outside']!r} on {rows}")
    assert port - scan == ref["outside"] + per_pair * (pairs - n_pairs / m)
