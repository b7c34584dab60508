"""Device time by program span (``bench/harness/spans.py``) on the CPU: the
attribution rules on hand-built profiler rows (a main thread, autograd's
thread, launches on system thread ids), every backward node of a smoke
training step resolved to the program span of its forward op, and the
benchmark's readers (``bench/harness/profile.py``) blind to the program's
ranges."""
import sys
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench.harness import profile as P  # noqa: E402
from bench.harness import spans as S  # noqa: E402

R = S.PREFIX
EVAL = S.EVAL


def _op(name, start, end, tid=1, seq=-1, fwd_tid=0, corr=0):
    return S.Row("op", name, start, end, tid, seq, fwd_tid, corr)


def _dev(name, start, end, corr=0, linked=0):
    return S.Row("device", name, start, end, corr=corr, linked=linked)


def _rows():
    """One step: main thread 1, autograd's thread 2, launches on system
    thread 900 (autograd's)."""
    return [
        _op(R + "train.step", 0, 1000),
        _op(R + "train.forward", 10, 300),
        _op(R + "model.layer_params", 20, 30),
        _op("aten::select", 21, 22, seq=5, corr=1),
        _op(R + "model.layer", 40, 200),
        _op(R + "model.norm", 50, 80),
        _op("aten::mul", 55, 60, seq=7, corr=2),        # makes node 7
        _op("aten::mm", 90, 100, seq=8, corr=3),        # model.layer's own
        _op("aten::embedding", 250, 260, seq=9, corr=4),
        _op(R + "train.backward", 300, 800),
        # autograd's thread: the layer recomputed, then node 7's backward
        _op(EVAL + "MmBackward0", 310, 400, tid=2, seq=8, fwd_tid=1),
        _op(R + "model.layer", 320, 390, tid=2),
        _op(R + "model.norm", 330, 350, tid=2),
        _op("aten::mul", 335, 340, tid=2, seq=1, corr=10),
        _op("aten::mm", 410, 420, tid=2, corr=11),       # outside any node
        _op(EVAL + "MulBackward0", 430, 480, tid=2, seq=7, fwd_tid=1),
        _op("aten::mul", 440, 445, tid=2, corr=12),
        _op(EVAL + "SelectBackward0", 490, 520, tid=2, seq=5, fwd_tid=1),
        _op("aten::zeros", 495, 500, tid=2, corr=13),
        _op(EVAL + "EmbeddingBackward0", 530, 560, tid=2, seq=9, fwd_tid=1),
        _op("aten::embedding_dense_backward", 535, 550, tid=2, corr=14),
        _op(R + "optim.adamw", 810, 990),
        _op("aten::add_", 820, 830, corr=15),
        S.Row("launch", "cudaLaunchKernel", 337, 338, 900, corr=501,
              linked=10),
        S.Row("launch", "cudaLaunchKernel", 442, 443, 900, corr=502),
        S.Row("launch", "cuLaunchKernelEx", 496, 497, 900, corr=503),
        _dev("mul_kernel", 1100, 1110, linked=2),
        _dev("gemm_kernel", 1110, 1130, linked=3),
        _dev("select_copy", 1130, 1131, linked=1),
        _dev("recompute_mul", 1140, 1150, corr=501, linked=10),
        _dev("outside_node", 1150, 1155, linked=11),
        _dev("mul_backward", 1160, 1170, corr=502),     # a launch, no link
        _dev("zeros_kernel", 1170, 1180, corr=503),     # ditto, no link
        _dev("embedding_backward", 1180, 1190, linked=14),
        _dev("adam_kernel", 1200, 1260, linked=15),
        _dev("Memset (Device)", 1260, 1262, corr=999),  # no anchor
        _dev("late_kernel", 5000, 5010, linked=15),     # past the window
    ]


def test_rules_on_hand_built_rows():
    owned = {o.op.name: o for o in S.attribute(_rows(), window=(0, 4000))}
    assert "late_kernel" not in owned
    want = {
        "mul_kernel": ("model.norm", "forward", 2),
        "gemm_kernel": ("model.layer", "forward", 2),
        "select_copy": ("model.layer_params", "forward", 2),
        "recompute_mul": ("model.norm", "recompute", 2),
        "outside_node": ("train.backward", "backward", 4),
        "mul_backward": ("model.norm", "backward", 3),
        "zeros_kernel": ("model.layer_params", "backward", 3),
        "embedding_backward": ("train.forward", "backward", 4),
        "adam_kernel": ("optim.adamw", "optimizer", 2),
        "Memset (Device)": (None, "step", 0),
    }
    assert {k: (o.owner, o.pass_, o.rule) for k, o in owned.items()} == want
    assert owned["mul_backward"].anchor == "launch"
    assert owned["recompute_mul"].anchor == "op"
    assert owned["Memset (Device)"].anchor == "none"


def test_split_metrics_table_and_parts():
    split = S.read(_rows(), window=(0, 4000), steps=2)
    m = split.metrics()
    assert set(m) == set(S.METRICS)
    ns = 1e6 * 2                                          # ms a step
    assert m["norm_ms_per_step"] == pytest.approx((10 + 10 + 10) / ns)
    assert m["recompute_ms_per_step"] == pytest.approx(10 / ns)
    assert m["layer_slice_ms_per_step"] == pytest.approx((1 + 10) / ns)
    assert m["optimizer_ms_per_step"] == pytest.approx(60 / ns)
    assert m["ce_ms_per_step"] is None
    total = split.ms(lambda o: True)
    assert total == pytest.approx(sum(r[2] for r in split.table()))
    parts = split.parts(lambda n: "gemm" in n, lambda n: "flash" in n)
    assert sum(parts.values()) == pytest.approx(total)
    assert parts["gemm (by name)"] == pytest.approx(20 / ns)
    assert parts["fallback (train.* or none)"] == pytest.approx(
        (5 + 10 + 2) / ns)
    assert split.fallback_share() == pytest.approx(17 / (total * ns))
    assert S.span_at(_rows(), 1, [5, 57, 95, 805, 900]) == [
        "train.step", "model.norm", "model.layer", "train.step",
        "optim.adamw"]
    assert S.host_ms(_rows(), "train.step", 2) == pytest.approx(1000 / ns)
    top = split.by_kernel(2)
    assert [t[0] for t in top] == ["adam_kernel", "gemm_kernel"]
    assert top[0][2] == {"optim.adamw": pytest.approx(60 / ns)}


class _Event:
    def __init__(self, name, device="CPU", start=0, dur=0, act=None,
                 tid=1, seq=-1, corr=0, linked=0):
        self._v = (name, device, start, dur, act, tid, seq, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[5]

    def fwd_thread_id(self):
        return 0

    def sequence_nr(self):
        return self._v[6]

    def correlation_id(self):
        return self._v[7]

    def linked_correlation_id(self):
        return self._v[8]


class _WithActivity(_Event):
    def activity_type(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _s: list(events)})()
        self.profiler = type("Inner", (), {"kineto_results": results})()


def _window_events():
    return [
        _Event("bench.window", start=0, dur=1000),
        _Event("bench.train_step", start=10, dur=500),
        _Event("bench.window", device="CUDA", start=100, dur=800),
        _Event("gemm_kernel", device="CUDA", start=100, dur=200),
        _Event("elementwise_kernel", device="CUDA", start=400, dur=100),
        _Event("Memcpy HtoD", device="CUDA", start=600, dur=50),
    ]


def _program_ranges():
    return [_Event(R + "train.step", start=10, dur=480),
            _Event(R + "model.norm", start=20, dur=30, corr=7)]


def test_reduce_is_blind_to_the_programs_ranges():
    """The program's ranges are host op records: the benchmark's reduction
    and every reader's arithmetic give what they give without them."""
    base = P.reduce(_Prof(_window_events()), steps=1)
    with_ranges = P.reduce(_Prof(_window_events() + _program_ranges()), 1)
    for field in ("kernels", "ops", "spans", "window", "steps"):
        assert getattr(base, field) == getattr(with_ranges, field)
    assert P.kernel_count(base) == P.kernel_count(with_ranges) == 2
    assert P.busy_ns(base) == P.busy_ns(with_ranges) == 350
    keep = lambda n: "gemm" in n  # noqa: E731
    assert P.matching_seconds(with_ranges, keep) == pytest.approx(200e-9)


def test_row_kinds():
    cases = [
        (_Event(R + "model.norm"), "op"),
        (_Event("aten::mm"), "op"),
        (_Event("cudaLaunchKernel"), "launch"),
        (_Event("cuLaunchKernelEx"), "launch"),
        (_Event("cudaMemcpyAsync"), "launch"),
        (_Event("gemm_kernel", device="CUDA"), "device"),
        (_Event("Memset (Device)", device="CUDA"), "device"),
        (_Event(R + "model.norm", device="CUDA"), None),
        (_Event("bench.window", device="CUDA"), None),
        (_WithActivity("anything", device="CUDA", act="gpu_user_annotation"),
         None),
        (_WithActivity("cudaStreamSynchronize", act="cuda_runtime"),
         "launch"),
        (_WithActivity("cuda_graph_op", act="cpu_op"), "op"),
    ]
    for event, kind in cases:
        assert S.row_kind(event) == kind, event.name()
    rows = S.rows(_Prof([c[0] for c in cases]))
    assert Counter(r.kind for r in rows) == Counter(
        k for _, k in cases if k is not None)


@pytest.fixture(scope="module")
def smoke_rows():
    """Rows of one profiled smoke training step on the CPU (two GQA
    layers, ``remat="full"``, the CE in four chunks), with a device row
    hand-linked to every ``aten::`` op: the CPU runs no device, so each op
    stands for the kernels it would launch."""
    import test_torch_train_spans as T
    _, params, opt, step, batch = T._setup()
    step(params, opt, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, batch)
    rows = S.rows(prof)
    dev = [_dev("k:" + r.name, r.start, r.end, linked=r.corr)
           for r in rows if r.kind == "op" and r.name.startswith("aten::")]
    return rows, dev


# backward nodes whose forward op no model span holds: the embedding
# lookup, the CE's slicing of the hidden states and labels into chunks
# (outside the chunk's checkpoint) and the mean's division
FALLBACK_NODES = {"EmbeddingBackward0", "SliceBackward0", "DivBackward0"}


def test_backward_nodes_resolve_to_program_spans(smoke_rows):
    rows, dev = smoke_rows
    ops = [r for r in rows if r.kind == "op"]
    scopes = S._scopes(ops)
    owned = S.attribute(rows + dev)
    node_at = S._innermost(scopes, [(1, o.op.start, k)
                                    for k, o in enumerate(owned)])
    nodes = Counter()
    for k, o in enumerate(owned):
        sc = node_at[k]
        if sc is None or sc.program:
            continue
        node = sc.name[len(S.EVAL):]
        nodes[node] += 1
        if o.rule == 3:
            assert o.pass_ == "backward"
            assert o.owner.startswith(("model.", "optim.")), (node, o.owner)
        else:
            assert (o.rule, o.owner) == (4, "train.forward"), (node, o)
            assert node in FALLBACK_NODES, node
    for node in ("MmBackward0", "SelectBackward0", "SiluBackward0",
                 "LogsumexpBackward0", "RsqrtBackward0"):
        assert nodes[node] > 0, node


def test_smoke_step_passes_and_metrics(smoke_rows):
    rows, dev = smoke_rows
    split = S.read(rows + dev, steps=1)
    passes = Counter((o.owner, o.pass_) for o in split.owned)
    for span in ("model.layer", "model.norm", "model.rope", "model.swiglu",
                 "model.ce", "model.ce_chunk"):
        for p in ("forward", "recompute", "backward"):
            assert passes[(span, p)] > 0, (span, p)
    assert passes[("model.layer_params", "forward")] > 0
    assert passes[("model.layer_params", "backward")] > 0
    assert passes[("model.layer_params", "recompute")] == 0
    assert passes[("optim.adamw", "optimizer")] > 0
    assert {p for (o, p) in passes if o == "optim.adamw"} == {"optimizer"}
    assert all(v is not None for v in split.metrics().values())
    assert not any(o.rule == 0 for o in split.owned)
