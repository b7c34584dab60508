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
(8 host devices, a subprocess) once attention is counted the reference's
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


REF_CELL = """
import os, sys, json
sys.path.insert(0, SRC)
from repro.configs import registry as R
from repro.launch.cells import build_cell
from repro.launch.mesh import make_test_mesh
from repro.core.hlo_analysis import analyze_hlo
R.SHAPES["tiny"] = R.ShapeSpec("tiny", 64, 8, "train")
cell = build_cell("internlm2-1.8b", "tiny", make_test_mesh((8, 1)),
                  cfg=R.get_smoke_config("internlm2-1.8b"))
print(json.dumps(analyze_hlo(cell.lower().compile().as_text())))
"""


def test_smoke_train_cell_flops_equal_the_reference_walker():
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", f"SRC = {SRC!r}\n"
                          + textwrap.dedent(REF_CELL)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        cell = build_cell("internlm2-1.8b", ShapeSpec("tiny", 64, 8, "train"),
                          make_test_mesh((8, 1)),
                          cfg=get_smoke_config("internlm2-1.8b"))
        trace, memory = cell.trace()
    finally:
        dist.destroy_process_group()
    res = TA.analyze_trace(trace)
    flash = [op for op in trace.ops if TA.flash_flops(op)]
    assert [op.base for op in flash] == ["flash_attention"] * 2 + [
        "flash_attention_backward"] * 2
    # the reference's attention: every pair of its one dense block, and
    # the backward's rowsum(dO * O) as a dot
    dense = 0.0
    for op in flash:
        b, h, s, d = op.inputs[0][0]
        per = 4 * d * s * s if op.base == "flash_attention" else (
            10 * d * s * s + 2 * s * d)
        dense += per * b * h
    port = res["flops"] - sum(TA.flash_flops(op) for op in flash) + dense
    assert port == ref["flops"]
    assert memory["peak_bytes_per_device"] > memory["argument_bytes"] > 0


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
    train cells on 8 host devices (one subprocess)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", f"SRC = {SRC!r}\n"
                          + textwrap.dedent(REF_RECURRENT)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


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
