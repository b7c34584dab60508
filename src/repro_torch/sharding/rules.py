"""Logical-axis -> mesh-axis sharding rules (``repro.sharding.rules``), on
``torch.distributed``'s DeviceMesh and DTensor.

Every ParamSpec and cache spec carries logical axis names; this module maps
them onto the mesh with the reference's two passes:

* divisibility: a dim whose size the mapped mesh axes' product does not
  divide falls back to fewer axes, then to replication (qwen3's 4 KV heads
  on model=16);
* no reuse: a mesh axis taken by an earlier dim of the same tensor is
  dropped from later dims (left to right, greedy).

``spec_partition`` returns the reference's ``PartitionSpec`` as a tuple, one
entry per tensor dim: ``None``, one axis name, or a tuple of axis names. It
reads only a ``{axis: size}`` view of the mesh (:func:`_mesh_shape`), so an
object with a dict ``.shape`` stands in for a mesh. :func:`placements` turns
such a tuple into DTensor placements, one per mesh dim: ``Shard(d)`` where
the mesh axis shards tensor dim ``d``, else ``Replicate()``. A dim sharded
over several mesh axes (``("pod", "data")``) is split major to minor in that
order, as JAX splits it; DTensor splits in mesh order, so such an entry must
name its axes in mesh order.

The hooks (``activation_constraint``, ``kv_replicated_constraint``,
``dim_constraint``) take the place of ``with_sharding_constraint``: inside
:func:`set_context` each redistributes a DTensor to the layout the reference
pins; on a plain tensor, or outside a context, each is an identity. Inside a
context, plain tensors that meet DTensors (positions, masks, constants) count
as replicated over the mesh (``implicit_replication``), as constants are
under ``jit``.

Under ``FSDP_RULES`` (ZeRO-3) the parameters are sharded on ``embed`` over
the batch axes, and DTensor cannot propagate the attention projections'
einsum over such weights. Inside ``set_context(..., fsdp=True)`` the models
therefore take each layer's parameters through :func:`gather_params` where
they slice it out of the stack, inside the rematerialised body, so that a
recomputation gathers again: an all-gather over ``("pod", "data")`` to the
``BASE_RULES`` layout, whose backward reduce-scatters the gradients back
to the parameters' shards.

The context is thread-local, as the reference's is. Autograd runs a CUDA
backward on a thread of its own, and recomputes checkpointed code there, so
checkpointed code is wrapped in :func:`carry_context`: it runs under the
context of the code that checkpointed it, wherever it runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections.abc import Mapping

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from ..models.specs import is_spec

BATCH_AXES = ("pod", "data")

# logical axis -> preferred mesh axes (tuple tried in order, greedy)
BASE_RULES = {
    "batch": (("pod", "data"),),
    "cache_batch": (("pod", "data"),),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "cache_seq": ("model",),
    # everything else replicated:
    "embed": (), "head_dim": (), "head_dim2": (), "layers": (),
    "kv_lora": (), "q_lora": (), "conv_k": (), "ssm_state": (),
    "seq": (),
}

FSDP_RULES = dict(BASE_RULES)
FSDP_RULES["embed"] = (("pod", "data"),)      # ZeRO-3-style param sharding


def _mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh, or ``mesh.shape`` where that
    is already a mapping."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_size(shape: dict, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(shape[a] for a in axes)


def _present(shape: dict, axes) -> tuple:
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in shape)


def spec_partition(mesh, spec, rules: dict) -> tuple:
    """The reference's ``PartitionSpec`` of ``spec`` on ``mesh``, as a
    tuple."""
    shape = _mesh_shape(mesh)
    used: set = set()
    parts = []
    for dim, ax in zip(spec.shape, spec.axes):
        placed = None
        for cand in rules.get(ax, ()):
            cand = tuple(a for a in _present(shape, cand) if a not in used)
            # drop trailing axes of the candidate until its product divides
            while cand and dim % _axes_size(shape, cand) != 0:
                cand = cand[:-1]
            if cand:
                placed = cand
                break
        if placed:
            used.update(placed)
            parts.append(placed if len(placed) > 1 else placed[0])
        else:
            parts.append(None)
    return tuple(parts)


def placements(mesh, spec) -> tuple:
    """DTensor placements of the partition tuple ``spec`` on ``mesh``: one
    per mesh dim, ``Shard(d)`` where that axis shards tensor dim ``d``."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {axes}, not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of {spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition tuple (the reference's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def distribute(t, sharding: NamedSharding):
    """``t`` (the same full tensor on every rank) as a DTensor laid out by
    ``sharding``; each rank keeps its own shard, nothing is sent."""
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def tree_shardings(mesh, specs, rules: dict):
    """A :class:`NamedSharding` for every ParamSpec of ``specs``."""
    if is_spec(specs):
        return NamedSharding(mesh, spec_partition(mesh, specs, rules))
    return {k: tree_shardings(mesh, v, rules) for k, v in specs.items()}


def batch_partition(mesh, ndim: int, seq_axis: int | None = None,
                    seq_mesh_axis: str = "model",
                    batch_size: int | None = None, axes=BATCH_AXES) -> tuple:
    """[B, ...] activations/inputs: batch over (pod, data), rest replicated;
    optionally shard one more dim (sequence) over ``seq_mesh_axis``. A batch
    size not divisible by the axes' product falls back to fewer axes (batch=1
    long-context decode replicates)."""
    shape = _mesh_shape(mesh)
    b = _present(shape, axes)
    if batch_size is not None:
        while b and batch_size % _axes_size(shape, b) != 0:
            b = b[:-1]
    parts: list = [b if len(b) > 1 else (b[0] if b else None)]
    parts += [None] * (ndim - 1)
    if seq_axis is not None and seq_mesh_axis in shape:
        parts[seq_axis] = seq_mesh_axis
    return tuple(parts)


def mesh_device(mesh):
    """This rank's device on ``mesh``: the current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_range(mesh, spec, dim: int, n: int) -> range:
    """The indices of tensor dim ``dim`` (of ``n``) that this rank holds
    under the partition ``spec``, major mesh axis first."""
    lo, size = 0, n
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements(mesh, spec)):
        if p == Shard(dim):
            k = mesh.size(i)
            if size % k:
                raise ValueError(f"{n} do not divide over {spec[dim]}")
            size //= k
            lo += coord[i] * size
    return range(lo, lo + size)


def local_pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, on each rank's
    local shard (a partial sum gathered first). For elementwise ops DTensor
    has no sharding rule for (log-sigmoid's backward)."""
    if not isinstance(x, DTensor):
        return fn(x)
    mesh = x.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return DTensor.from_local(fn(x.redistribute(mesh, pl).to_local()), mesh,
                              pl)


def on_local_shards(fn, args, dims, out_dims, n_heads: int):
    """``fn(*args)`` on each rank's local shards, for a computation that is
    independent over batch rows and heads (a recurrent scan and the
    projections into it). ``dims`` gives each arg's ``(batch dim, heads
    dim)``, either None; the first arg is a DTensor with a batch dim at
    dim 0. The batch is split as the activations are
    (``activation_constraint``: over the batch axes, the model axis too
    under ``extra_dp``, as far as they divide it). The mesh's model axis,
    where no batch shard sits, splits every arg with a heads dim over
    heads where ``n_heads`` divide it, else over batch rows where they
    divide it, else over the (row, head) pairs (:class:`_PairSplit`).
    Any other shard is gathered first; an arg without the dim a mesh dim
    splits is whole there, its gradient a partial sum. Plain tensors
    count as replicated. ``out_dims``: each output's ``(batch dim, heads
    dim)``, laid out as the args are. Returns the outputs as DTensors (a
    tuple, as ``fn`` returns them)."""
    first = args[0]
    mesh = first.device_mesh
    batch, heads, pairs = _scan_split(first, dims[0][0], n_heads)
    pair = _PairSplit.of(first, n_heads, batch, pairs)

    def placed(bd, hd, grad=False):
        out = []
        for bt, h, pr in zip(batch, heads, pairs):
            if bt and bd is not None:
                out.append(Shard(bd))
            elif h and hd is not None:
                out.append(Shard(hd))
            else:
                out.append(Partial() if grad and (bt or h or pr)
                           else Replicate())
        return out

    def local(t, bd, hd):
        if t is None:
            return None
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        t = _Placed.apply(t, placed(bd, hd)).to_local(
            grad_placements=placed(bd, hd, grad=True))
        return t if pair is None else pair.to_pairs(t, bd, hd)

    outs = fn(*(local(t, *d) for t, d in zip(args, dims)))
    if pair is not None:
        outs = [pair.from_pairs(o, hd) for o, (_, hd) in zip(outs, out_dims)]
    return tuple(DTensor.from_local(o, mesh, placed(*d))
                 for o, d in zip(outs, out_dims))


@dataclasses.dataclass
class _PairSplit:
    """The (row, head) pairs of a rank's batch shard split over one mesh
    dim: pair ``p`` is row ``p // n_heads``, head ``p % n_heads``, and this
    rank takes pairs ``[lo, lo + n)`` of ``n_pairs``, ``per = ceil(n_pairs
    / m)`` a rank on ``m`` ranks (the trailing ranks fewer, or none), as
    GSPMD splits an uneven dim. ``fn`` sees one row whose heads are the
    rank's pairs; the args come whole and each rank takes its pairs, the
    outputs are gathered."""
    mesh: object
    dim: int
    n_heads: int
    n_pairs: int
    per: int
    lo: int
    n: int

    @classmethod
    def of(cls, t, n_heads: int, batch, pairs):
        """The split of DTensor ``t``'s batch where a mesh dim splits the
        pairs, else None."""
        if not any(pairs):
            return None
        mesh = t.device_mesh
        dim = pairs.index(True)
        n_pairs = t.shape[0] // math.prod(
            mesh.size(i) for i, bt in enumerate(batch) if bt) * n_heads
        per = -(-n_pairs // mesh.size(dim))
        lo = min(mesh.get_coordinate()[dim] * per, n_pairs)
        return cls(mesh, dim, n_heads, n_pairs, per, lo,
                   min(per, n_pairs - lo))

    def _index(self, of_row: bool, device):
        """Each of the rank's pairs' row (or head)."""
        return torch.tensor([(self.lo + j) // self.n_heads if of_row
                             else (self.lo + j) % self.n_heads
                             for j in range(self.n)], dtype=torch.long,
                            device=device)

    def to_pairs(self, t, bd, hd):
        """Local ``t`` as ``fn`` takes it: one row whose heads are the
        rank's pairs. A per-head weight (no batch dim) is indexed by their
        heads; an input shared by the heads (no heads dim) by their rows,
        which become a heads dim before its last dim."""
        if bd is None:
            return t if hd is None else t.index_select(
                hd, self._index(False, t.device))
        if hd is None:
            return t.index_select(bd, self._index(True, t.device))[
                None].movedim(1, -2)
        return t.movedim(hd, 1).flatten(0, 1).narrow(
            0, self.lo, self.n)[None].movedim(1, hd)

    def from_pairs(self, o, hd):
        """``fn``'s output ``o`` in the rank's rows x heads layout, every
        rank's pairs gathered."""
        o = o.movedim(hd, 1)[0]                             # [n, ...]
        o = torch.cat([o, o.new_zeros((self.per - self.n,) + o.shape[1:])])
        o = DTensor.from_local(o, self.mesh, [
            Shard(0) if i == self.dim else Replicate()
            for i in range(self.mesh.ndim)]).redistribute(
            self.mesh, [Replicate()] * self.mesh.ndim).to_local()
        return o[:self.n_pairs].unflatten(0, (-1, self.n_heads)).movedim(
            1, hd)


class _Placed(torch.autograd.Function):
    """DTensor ``t`` redistributed to ``pl``, its gradient left laid out
    as it comes back (``pl``'s layout), a partial sum reduced to ``t``'s
    own placement. ``redistribute``'s own backward would gather the
    gradient back to ``t``'s layout (and where ``t`` is a partial sum, on
    every rank), and the products before it would then run their
    backward whole on every rank of a mesh dim that split the scan."""

    @staticmethod
    def forward(ctx, t, pl):
        ctx.placements = t.placements
        return t.redistribute(t.device_mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        pl = [(q if not q.is_partial() else Replicate()) if p.is_partial()
              else p for p, q in zip(grad.placements, ctx.placements)]
        if list(grad.placements) != pl:
            grad = grad.redistribute(grad.device_mesh, pl)
        return grad, None


def _scan_split(t, bdim: int, n_heads: int):
    """For each mesh dim of DTensor ``t``'s mesh: does it split the batch
    rows, the heads, or the (row, head) pairs (:func:`on_local_shards`)."""
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    axes = (("pod", "data", "model") if getattr(_ctx, "extra_dp", False)
            else BATCH_AXES)
    spec = batch_partition(mesh, 1, batch_size=t.shape[bdim], axes=axes)
    batch = [p == Shard(0) for p in placements(mesh, spec)]
    split = math.prod(mesh.size(i) for i, bt in enumerate(batch) if bt)
    heads = [False] * mesh.ndim
    pairs = [False] * mesh.ndim
    for i, name in enumerate(names):
        if name != "model" or batch[i]:
            continue
        if n_heads % mesh.size(i) == 0:
            heads[i] = True
        elif t.shape[bdim] % (split * mesh.size(i)) == 0:
            batch[i] = True
        else:
            pairs[i] = True
    return batch, heads, pairs


def unshard_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank (a DTensor whose
    mesh axes shard that dim gathers it; others as they are). For a gather
    along a dim that is sharded, as a vocab-parallel head's logits are."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if list(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def local_rows(t, dim: int) -> tuple:
    """``(first index, count)`` of DTensor ``t``'s dim ``dim`` that this
    rank holds: ``torch.chunk``'s split over each mesh dim that shards it,
    major first (a trailing rank may hold fewer, or none)."""
    off, size = 0, t.shape[dim]
    coord = t.device_mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            chunk = -(-size // t.device_mesh.size(i))
            off += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return off, size


def write_seq(cache, start: int, value):
    """``cache[:, start:start + n] = value`` in place, ``n`` being
    ``value.shape[1]``: a prompt's or a decode step's rows of a serving
    cache ``[B, S, ...]``. On a DTensor cache each rank writes the rows of
    its own shard (indexing a dim the mesh shards would write into a
    gathered copy and lose the rows)."""
    n = value.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, start:start + n] = value
        return
    mesh = cache.device_mesh
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim)
    pl = [Replicate() if p.is_shard(1) else p for p in cache.placements]
    v = value.redistribute(mesh, pl).to_local()
    local = cache.to_local()
    off, _ = local_rows(cache, 1)
    lo, hi = max(start, off), min(start + n, off + local.shape[1])
    if lo < hi:
        local[:, lo - off:hi - off] = v[:, lo - start:hi - start]


def _constrain(x, spec):
    """``x`` redistributed to ``spec`` on its mesh (DTensors only)."""
    if not isinstance(x, DTensor):
        return x
    pl = placements(x.device_mesh, spec)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def settle_grad(x):
    """``x`` as it is; on a DTensor, its gradient is laid out as ``x`` is
    (a partial sum reduced, a gathered one sliced) before it flows further
    back. DTensor picks each op's layout by its communication alone: a
    gradient left partial or gathered makes the products before it run
    their backward whole on every rank of the model axis (and a
    vocab-sharded embedding lookup's masked partial sum cannot take a
    partial-sum gradient at all)."""
    if not (isinstance(x, DTensor) and x.requires_grad
            and torch.is_grad_enabled()):
        return x
    pl = x.placements
    return DTensor.from_local(x.to_local(grad_placements=pl), x.device_mesh,
                              pl, run_check=False, shape=x.shape,
                              stride=x.stride())


def contraction_split(x, w):
    """``x`` laid out for ``x @ w``: split over its last dim on each mesh
    dim where ``w`` splits its rows (the contracted dim) and ``x`` is
    whole, as the product reads it there. DTensor would take the
    product's weight gradient ``x^T @ dout`` whole on every rank of such a
    mesh dim and slice it (both layouts cost it no communication); split,
    each rank computes its own rows, and the gradient of ``x`` is
    gathered."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    pl = [Shard(x.ndim - 1) if q == Shard(0) and p == Replicate() else p
          for p, q in zip(x.placements, w.placements)]
    if list(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def dim_constraint(x, axis: int, mesh_axis: str = "model"):
    """Shard one activation dim over a mesh axis (no-op outside set_context
    or when not divisible). Used for MoE expert buffers and SSM head
    tensors."""
    mesh = getattr(_ctx, "mesh", None)
    if mesh is None:
        return x
    shape = _mesh_shape(mesh)
    if mesh_axis not in shape or x.shape[axis] % shape[mesh_axis] != 0:
        return x
    parts = [None] * x.ndim
    parts[axis] = mesh_axis
    return _constrain(x, tuple(parts))


# --------------------------------------------------------------- context ----

_ctx = threading.local()

def _implicit_replication():
    """DTensor's ``implicit_replication``, entered only where the switch is
    off: the library's turns it off on exit, which would end it for an
    enclosing context (the switch is process-wide in some torch releases
    and per thread in others). Reading the switch takes DTensor's private
    ``_op_dispatcher._allow_implicit_replication``, the attribute the
    library's context manager sets (torch 2.11 and 2.13);
    ``tests/test_torch_sharding.py`` fails if it goes."""
    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


def _state() -> tuple:
    return (getattr(_ctx, "mesh", None), getattr(_ctx, "seq_shard", False),
            getattr(_ctx, "extra_dp", False), getattr(_ctx, "fsdp", False))


@contextlib.contextmanager
def set_context(mesh, enabled: bool = True, seq_shard: bool = False,
                extra_dp: bool = False, fsdp: bool = False):
    prev = _state()
    _ctx.mesh = mesh if enabled else None
    _ctx.seq_shard = seq_shard
    _ctx.extra_dp = extra_dp
    _ctx.fsdp = fsdp
    try:
        with (_implicit_replication() if _ctx.mesh is not None
              else contextlib.nullcontext()):
            yield
    finally:
        _ctx.mesh, _ctx.seq_shard, _ctx.extra_dp, _ctx.fsdp = prev


def carry_context(fn):
    """``fn`` run under the caller's current context wherever it is called
    later (checkpointed code, which autograd recomputes on its own
    thread)."""
    mesh, seq_shard, extra_dp, fsdp = _state()
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with set_context(mesh, seq_shard=seq_shard, extra_dp=extra_dp,
                         fsdp=fsdp):
            return fn(*args, **kwargs)
    return run


def _gathered(t):
    """A DTensor parameter with its shards over the batch axes gathered
    (``FSDP_RULES`` -> ``BASE_RULES``: only ``embed`` differs, and no
    parameter of the base layout is sharded over a batch axis)."""
    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    pl = [Replicate() if names[i] in BATCH_AXES and p.is_shard() else p
          for i, p in enumerate(t.placements)]
    if list(t.placements) == pl:
        return t
    return t.redistribute(t.device_mesh, pl)


def gather_params(tree):
    """ZeRO-3's gather: inside ``set_context(..., fsdp=True)``, every
    DTensor leaf of ``tree`` (a parameter tensor or a dict of them) laid
    out as ``BASE_RULES`` lays it out, an all-gather over ``("pod",
    "data")`` whose backward is the gradients' reduce-scatter; elsewhere
    ``tree`` as it is."""
    if not getattr(_ctx, "fsdp", False):
        return tree
    if isinstance(tree, Mapping):
        return {k: gather_params(v) for k, v in tree.items()}
    return _gathered(tree)


def context_mesh():
    """The mesh of the innermost :func:`set_context`, or None."""
    return getattr(_ctx, "mesh", None)


def activation_constraint(x):
    """batch -> (pod, data); optionally seq (dim 1) -> model.

    Sequence parallelism (`seq_shard`) keeps every activation sharded over
    the model axis on the sequence dim — the layout for archs whose head
    counts don't divide the model axis (phi3 40H, minicpm3 40H, llava 56H):
    per-token ops stay parallel over the model axis, and attention
    all-gathers only K/V.
    """
    mesh = getattr(_ctx, "mesh", None)
    if mesh is None:
        return x
    shape = _mesh_shape(mesh)
    seq_axis = None
    if (getattr(_ctx, "seq_shard", False) and x.ndim >= 3
            and "model" in shape and x.shape[1] % shape["model"] == 0):
        seq_axis = 1
    axes = (("pod", "data", "model") if getattr(_ctx, "extra_dp", False)
            else BATCH_AXES)
    return _constrain(x, batch_partition(mesh, x.ndim, seq_axis,
                                         batch_size=x.shape[0], axes=axes))


def kv_replicated_constraint(x):
    """Pin K/V to batch-only sharding (seq replicated) — the one all-gather
    of sequence-parallel attention."""
    mesh = getattr(_ctx, "mesh", None)
    if mesh is None or not getattr(_ctx, "seq_shard", False):
        return x
    return _constrain(x, batch_partition(mesh, x.ndim,
                                         batch_size=x.shape[0]))
