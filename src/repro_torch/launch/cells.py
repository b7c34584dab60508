"""The step, its fake inputs and their shardings for every (architecture ×
input shape) dry-run cell (``repro.launch.cells``).

``build_cell(arch, shape, mesh)`` returns a :class:`Cell` whose
:meth:`Cell.trace` runs the step once on fake tensors (``FakeTensorMode``)
laid out as DTensors over ``mesh``, under the op-trace recorder of
``core/trace_analysis.py``: **nothing is allocated anywhere**, so a 671B
model's step is traced on a laptop. The models' loops are folded there
(``models/loop.py``: a middle iteration traced once and counted for all
but the first and last). ``mesh`` is a DeviceMesh, usually over a world
of the ``fake`` backend of the production mesh's size
(``launch/dryrun.py``). The tensors are fake tensors on the mesh's device:
``cuda`` where torch has CUDA; on a torch without it, CPU, since autograd
there cannot take gradients of fake CUDA tensors. Either way the step takes
the card's route, since fake tensors do, flash kernels included (one op
each in the trace).

Rules, thresholds and the three branches (train, prefill, decode) are the
reference's. Where the reference donates an argument, the port's step
updates it in place (``donate_argnums`` says which). A decode cell's ``pos``
is the last position, ``seq_len - 1``: the port's decode reads only the
visible cache rows, so that is the step that reads all of them, as the
reference's masked read does.

The shardings alone (``in_shardings``, ``out_shardings``) need only an
object with a ``{axis: size}`` ``shape``, so a stand-in mesh gives the
reference's partitions for every cell; ``Cell.args`` needs a DeviceMesh.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from ..configs.registry import SHAPES, active_param_count, get_config
from ..core.trace_analysis import TraceRecorder
from ..models import encdec, lm
from ..models.encdec import EncDecConfig
from ..models.specs import ParamSpec, is_spec, n_params
from ..sharding import rules as R
from ..train.optim import AdamWConfig
from ..train.step import TrainConfig, make_train_step, optimizer_specs

FSDP_THRESHOLD = 2e9           # params above this get ZeRO-3-style sharding
INT8_OPT_THRESHOLD = 1e11      # moments in int8 above this (deepseek-v3)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    arg_specs: tuple             # ParamSpec trees (a decode's pos: an int)
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple
    n_params: int
    n_active_params: float
    model_flops: float           # 6ND (train) / 2ND (serve) per step, global
    mesh: Any
    fsdp: bool

    @functools.cached_property
    def fake_mode(self):
        from torch._subclasses.fake_tensor import FakeTensorMode
        return FakeTensorMode(allow_non_fake_inputs=True)

    @functools.cached_property
    def args(self) -> tuple:
        """The step's arguments: fake tensors laid out by ``in_shardings``
        as DTensors over ``mesh`` (a plain int stays as it is)."""
        dev = torch.device(self.mesh.device_type)
        with self.fake_mode:
            return tuple(_fake_tree(s, sh, dev) for s, sh in
                         zip(self.arg_specs, self.in_shardings))

    def trace(self, fold: bool = True):
        """Run the step once on :attr:`args` under the recorder, its loops
        folded (one iteration traced, counted by the trip count) unless
        ``fold`` is False. Returns ``(trace, memory)``: the
        :class:`..core.trace_analysis.Trace` of this rank's ops, and the
        memory figures of the reference's ``memory_analysis()`` in bytes of
        this rank's local tensors (arguments, outputs, temporaries at the
        peak, outputs that are arguments updated in place). Call it once a
        cell: the step updates :attr:`args` in place."""
        args = self.args
        arg_storages = _storages(args)
        rec = TraceRecorder(self.fake_mode, track=_tensor_leaves(args),
                            fold=fold)
        with rec:
            out = self.step_fn(*args)
        trace = rec.trace()
        out_storages = _storages(out)
        arg_b = sum(arg_storages.values())
        out_b = sum(out_storages.values())
        alias_b = sum(n for k, n in out_storages.items()
                      if k in arg_storages)
        temp_b = max(0, trace.peak_bytes - (arg_b + out_b - alias_b))
        memory = {"argument_bytes": arg_b, "output_bytes": out_b,
                  "temp_bytes": temp_b, "alias_bytes": alias_b,
                  "peak_bytes_per_device": arg_b + out_b + temp_b - alias_b}
        return trace, memory


def _tensor_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensor_leaves(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensor_leaves(x)]
    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _storages(tree) -> dict:
    """``{storage id: bytes}`` of the local tensors of ``tree``."""
    out = {}
    for t in _tensor_leaves(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def _local_shape(shape, mesh, placements) -> tuple:
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return tuple(local)


def _fake_leaf(spec: ParamSpec, sharding, device):
    mesh, pl = sharding.mesh, sharding.placements
    if spec.shape == () and spec.dtype == torch.int32:
        # the optimizer's step: a host scalar the update reads
        return torch.tensor(0, dtype=torch.int32)
    local = torch.empty(_local_shape(spec.shape, mesh, pl), dtype=spec.dtype,
                        device=device)
    stride = tuple(math.prod(spec.shape[i + 1:])
                   for i in range(len(spec.shape)))
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(spec.shape), stride=stride)


def _fake_tree(specs, shardings, device):
    if is_spec(specs):
        return _fake_leaf(specs, shardings, device)
    if isinstance(specs, dict):
        return {k: _fake_tree(v, shardings[k], device)
                for k, v in specs.items()}
    return specs                       # a plain value (decode's pos)


def _pick_rules(cfg, mesh, fsdp: bool, kind: str):
    rules = dict(R.FSDP_RULES if fsdp else R.BASE_RULES)
    model_size = R._mesh_shape(mesh).get("model", 1)
    kv = getattr(cfg, "n_kv_heads", 0)
    if kind in ("decode", "prefill"):
        if kv and kv % model_size == 0:
            rules["cache_seq"] = ()          # prefer head-sharded caches
    if getattr(cfg, "prefer_dp", False):
        # small models: use the model axis as extra DP; params ZeRO over model
        rules["batch"] = (("pod", "data", "model"), ("pod", "data"))
        rules["cache_batch"] = rules["batch"]
        for ax in ("heads", "kv_heads", "mlp", "vocab", "expert"):
            rules[ax] = ()
        rules["embed"] = ("model",)
    return rules


def _spec(shape, dtype) -> ParamSpec:
    """An input's ParamSpec: batch first, the rest without a rule."""
    axes = ("batch",) + ("seq",) * (len(shape) - 1)
    return ParamSpec(tuple(shape), dtype, axes, "zeros")


def _batch_shardings(mesh, batch: dict, axes=R.BATCH_AXES) -> dict:
    return {k: R.NamedSharding(mesh, R.batch_partition(
        mesh, len(s.shape), batch_size=s.shape[0], axes=axes))
        for k, s in batch.items()}


def build_cell(arch: str, shape, mesh, fsdp: bool | None = None,
               cfg=None, overrides: dict | None = None) -> Cell:
    """The cell of ``arch`` at ``shape`` (a name in ``SHAPES`` or a
    :class:`ShapeSpec`) on ``mesh``; ``fsdp`` None chooses ``FSDP_RULES``
    above ``FSDP_THRESHOLD`` parameters, as the reference does."""
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    is_encdec = isinstance(cfg, EncDecConfig)
    specs = encdec.encdec_specs(cfg) if is_encdec else lm.lm_specs(cfg)
    np_total = n_params(specs)
    if fsdp is None:
        fsdp = np_total > FSDP_THRESHOLD
    rules = _pick_rules(cfg, mesh, fsdp, shape.kind)
    p_shard = R.tree_shardings(mesh, specs, rules)
    n_active = active_param_count(cfg)
    b, s = shape.global_batch, shape.seq_len
    seq_shard = bool(getattr(cfg, "seq_shard_attn", False))
    bf16, ids = torch.bfloat16, torch.int64

    if shape.kind == "train":
        state_dtype = "int8" if np_total > INT8_OPT_THRESHOLD else "fp32"
        tcfg = TrainConfig(adam=AdamWConfig(lr=3e-4, grad_clip=1.0,
                                            state_dtype=state_dtype))
        o_specs = optimizer_specs(specs, tcfg)
        o_shard = R.tree_shardings(mesh, o_specs, rules)

        if is_encdec:
            half = s // 2
            batch = {"frames": _spec((b, half, cfg.d_model), bf16),
                     "tokens": _spec((b, half), ids),
                     "labels": _spec((b, half), ids)}

            def loss_fn(params, bt):
                return encdec.encdec_loss(params, cfg, bt["frames"],
                                          bt["tokens"], bt["labels"])
        elif cfg.prefix_len:
            text = s - cfg.prefix_len
            batch = {"prefix": _spec((b, cfg.prefix_len, cfg.d_model), bf16),
                     "tokens": _spec((b, text), ids),
                     "labels": _spec((b, text), ids)}

            def loss_fn(params, bt):
                return lm.lm_loss(params, cfg, bt["tokens"], bt["labels"],
                                  bt["prefix"])
        else:
            batch = {"tokens": _spec((b, s), ids),
                     "labels": _spec((b, s), ids)}

            def loss_fn(params, bt):
                return lm.lm_loss(params, cfg, bt["tokens"], bt["labels"])

        raw_step = make_train_step(loss_fn, tcfg)
        extra_dp = bool(getattr(cfg, "prefer_dp", False))

        def step(params, opt_state, bt):
            with R.set_context(mesh, seq_shard=seq_shard, extra_dp=extra_dp,
                               fsdp=fsdp):
                return raw_step(params, opt_state, bt)

        batch_axes = (("pod", "data", "model") if extra_dp
                      else R.BATCH_AXES)
        b_shard = _batch_shardings(mesh, batch, batch_axes)
        return Cell(arch, shape.name, "train", step,
                    (specs, o_specs, batch),
                    (p_shard, o_shard, b_shard),
                    (p_shard, o_shard, None),
                    donate_argnums=(0, 1),
                    n_params=np_total, n_active_params=n_active,
                    model_flops=6.0 * n_active * b * s,
                    mesh=mesh, fsdp=fsdp)

    # ---- serving shapes ----
    if is_encdec:
        enc_len = s // 2 if shape.kind == "prefill" else 4096
        dec_len = s // 2 if shape.kind == "prefill" else s
        c_specs = encdec.cache_specs(cfg, b, dec_len, enc_len)
    else:
        c_specs = lm.cache_specs(cfg, b, s)
    c_shard = R.tree_shardings(mesh, c_specs, rules)

    if shape.kind == "prefill":
        if is_encdec:
            batch = {"frames": _spec((b, enc_len, cfg.d_model), bf16),
                     "tokens": _spec((b, dec_len), ids)}

            def step(params, bt, cache):
                with torch.no_grad(), R.set_context(mesh, fsdp=fsdp):
                    return encdec.prefill(params, cfg, bt["frames"],
                                          bt["tokens"], cache)
        elif cfg.prefix_len:
            text = s - cfg.prefix_len
            batch = {"prefix": _spec((b, cfg.prefix_len, cfg.d_model), bf16),
                     "tokens": _spec((b, text), ids)}

            def step(params, bt, cache):
                with torch.no_grad(), R.set_context(
                        mesh, seq_shard=seq_shard, fsdp=fsdp):
                    return lm.prefill(params, cfg, bt["tokens"], cache,
                                      bt["prefix"])
        else:
            batch = {"tokens": _spec((b, s), ids)}

            def step(params, bt, cache):
                with torch.no_grad(), R.set_context(
                        mesh, seq_shard=seq_shard, fsdp=fsdp):
                    return lm.prefill(params, cfg, bt["tokens"], cache)

        return Cell(arch, shape.name, "prefill", step,
                    (specs, batch, c_specs),
                    (p_shard, _batch_shardings(mesh, batch), c_shard),
                    (None, c_shard),
                    donate_argnums=(2,),
                    n_params=np_total, n_active_params=n_active,
                    model_flops=2.0 * n_active * b * s,
                    mesh=mesh, fsdp=fsdp)

    # ---- decode ----
    tok = _spec((b, 1), ids)
    model = encdec if is_encdec else lm

    def step(params, cache, token, pos):
        with torch.no_grad(), R.set_context(mesh, fsdp=fsdp):
            return model.decode_step(params, cfg, cache, token, pos)
    return Cell(arch, shape.name, "decode", step,
                (specs, c_specs, tok, s - 1),
                (p_shard, c_shard, R.NamedSharding(
                    mesh, R.batch_partition(mesh, 2, batch_size=b)),
                 R.NamedSharding(mesh, ())),
                (None, c_shard),
                donate_argnums=(1,),
                n_params=np_total, n_active_params=n_active,
                model_flops=2.0 * n_active * b,
                mesh=mesh, fsdp=fsdp)
