"""Spike-ResNet18 / Spike-VGG16 / Spike-ResNet50 (the paper's workloads, §5.1).

An architecture is a descriptor list; ``model_specs``, ``init_state`` and
``model_step`` walk the same descriptors the profiler (`snn.profile`) and the
partitioner see. Time is a Python loop over ``cfg.T`` in ``model_rollout``,
with the per-layer LIF membrane states as the carry; BPTT backpropagates
through that loop.

Parameters live in a :class:`SpikingNet`, an ``nn.ModuleDict`` whose
parameter names are the reference's pytree paths (``conv3.conv.w``,
``s1b0.s1b0c1.bn.scale``, ``fc.b``). The port computes in NCHW with OIHW conv
weights (``snn.layers``); the public functions take the reference's NHWC
input, and :func:`from_reference_params` / :func:`to_reference_params` carry
weights across in the reference's HWIO layout. The LIF states that
``init_state`` and ``model_step`` carry are NCHW.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .neurons import LIFConfig, lif_step


# ---- descriptors -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvBNLif:
    name: str
    cin: int
    cout: int
    k: int = 3
    stride: int = 1
    spike_out: bool = True    # False: BN only (pre-residual-add branch)


@dataclasses.dataclass(frozen=True)
class Residual:
    name: str
    body: tuple               # tuple[ConvBNLif, ...] (last one spike_out=False)
    downsample: Any = None    # optional ConvBNLif (1x1, spike_out=False)


@dataclasses.dataclass(frozen=True)
class MaxPool:
    name: str
    k: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class Classifier:
    name: str
    din: int
    dout: int


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    name: str
    blocks: tuple
    n_classes: int
    in_res: int
    in_ch: int = 3
    T: int = 4
    lif: LIFConfig = LIFConfig()


# ---- model constructors -----------------------------------------------------

def _resnet_blocks(stage_plan, widths, bottleneck: bool, width_mult: float,
                   in_ch: int):
    w = lambda c: max(int(c * width_mult), 8)
    blocks = [ConvBNLif("stem", in_ch, w(64), k=7, stride=2),
              MaxPool("stem_pool", 3, 2)]
    cin = w(64)
    for si, (n_blocks, width) in enumerate(zip(stage_plan, widths)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            cout = w(width) * (4 if bottleneck else 1)
            if bottleneck:
                body = (
                    ConvBNLif(f"s{si}b{bi}c1", cin, w(width), 1, stride),
                    ConvBNLif(f"s{si}b{bi}c2", w(width), w(width), 3, 1),
                    ConvBNLif(f"s{si}b{bi}c3", w(width), cout, 1, 1,
                              spike_out=False),
                )
            else:
                body = (
                    ConvBNLif(f"s{si}b{bi}c1", cin, cout, 3, stride),
                    ConvBNLif(f"s{si}b{bi}c2", cout, cout, 3, 1,
                              spike_out=False),
                )
            down = None
            if stride != 1 or cin != cout:
                down = ConvBNLif(f"s{si}b{bi}down", cin, cout, 1, stride,
                                 spike_out=False)
            blocks.append(Residual(f"s{si}b{bi}", body, down))
            cin = cout
    return tuple(blocks), cin


def spike_resnet18(n_classes=10, in_res=32, T=4, width_mult=1.0,
                   in_ch=3) -> SNNConfig:
    blocks, cout = _resnet_blocks([2, 2, 2, 2], [64, 128, 256, 512], False,
                                  width_mult, in_ch)
    blocks = blocks + (Classifier("fc", cout, n_classes),)
    return SNNConfig("spike-resnet18", blocks, n_classes, in_res, in_ch, T)


def spike_resnet50(n_classes=10, in_res=32, T=4, width_mult=1.0,
                   in_ch=3) -> SNNConfig:
    blocks, cout = _resnet_blocks([3, 4, 6, 3], [64, 128, 256, 512], True,
                                  width_mult, in_ch)
    blocks = blocks + (Classifier("fc", cout, n_classes),)
    return SNNConfig("spike-resnet50", blocks, n_classes, in_res, in_ch, T)


def spike_vgg16(n_classes=10, in_res=32, T=4, width_mult=1.0,
                in_ch=3) -> SNNConfig:
    plan = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]
    w = lambda c: max(int(c * width_mult), 8)
    blocks: list = []
    cin, i = in_ch, 0
    for item in plan:
        if item == "M":
            blocks.append(MaxPool(f"pool{i}"))
        else:
            blocks.append(ConvBNLif(f"conv{i}", cin, w(item), 3, 1))
            cin = w(item)
            i += 1
    blocks.append(Classifier("fc", cin, n_classes))
    return SNNConfig("spike-vgg16", tuple(blocks), n_classes, in_res, in_ch, T)


# ---- specs / parameters ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf in the reference's layout (conv weights HWIO) and
    its initializer: ``normal`` | ``ones`` | ``zeros``."""
    shape: tuple
    init: str = "normal"


def _conv_unit_specs(u: ConvBNLif):
    return {"conv": {"w": ParamSpec((u.k, u.k, u.cin, u.cout))},
            "bn": {"scale": ParamSpec((u.cout,), "ones"),
                   "bias": ParamSpec((u.cout,), "zeros")}}


def model_specs(cfg: SNNConfig):
    """Nested dict of :class:`ParamSpec`, keyed as the reference's
    ``model_specs``."""
    out: dict = {}
    for b in cfg.blocks:
        if isinstance(b, ConvBNLif):
            out[b.name] = _conv_unit_specs(b)
        elif isinstance(b, Residual):
            d = {u.name: _conv_unit_specs(u) for u in b.body}
            if b.downsample is not None:
                d[b.downsample.name] = _conv_unit_specs(b.downsample)
            out[b.name] = d
        elif isinstance(b, Classifier):
            out[b.name] = {"w": ParamSpec((b.din, b.dout)),
                           "b": ParamSpec((b.dout,), "zeros")}
    return out


def _draw(spec: ParamSpec, generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape)
    if spec.init == "ones":
        return torch.ones(spec.shape)
    # the reference's rule (repro.models.specs._init_one): std 1/sqrt(shape[0]),
    # which for an HWIO conv weight is 1/sqrt(kh), not 1/sqrt(kh * kw * cin)
    std = 1.0 / math.sqrt(max(spec.shape[0], 1))
    return std * torch.randn(spec.shape, generator=generator)


def _to_port(x: torch.Tensor) -> torch.Tensor:
    """Reference layout -> port layout: HWIO conv weights become OIHW."""
    return x.permute(3, 2, 0, 1).contiguous() if x.dim() == 4 else x


def _to_reference(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 3, 1, 0) if x.dim() == 4 else x


def _is_group(tree) -> bool:
    return all(isinstance(v, ParamSpec) for v in tree.values())


class SpikingNet(nn.ModuleDict):
    """The parameters of one spiking model, named by the reference's pytree
    paths, with keys in sorted order (the reference's leaf order).
    ``net(x)`` is :func:`model_rollout`."""

    def __init__(self, cfg: SNNConfig, leaf, device=None):
        """``leaf(path, spec)`` gives each parameter in the reference's
        layout; it is stored in the port's."""
        dev = resolve_device(device)

        def build(tree, path):
            if _is_group(tree):
                return nn.ParameterDict({
                    k: nn.Parameter(_to_port(leaf(path + (k,), tree[k]))
                                    .to(dev, torch.float32))
                    for k in sorted(tree)})
            return nn.ModuleDict({k: build(tree[k], path + (k,))
                                  for k in sorted(tree)})

        specs = model_specs(cfg)
        super().__init__({k: build(specs[k], (k,)) for k in sorted(specs)})
        self.cfg = cfg

    def forward(self, x):
        return model_rollout(self, self.cfg, x)


def init_model(cfg: SNNConfig, generator: torch.Generator | None = None,
               device=None) -> SpikingNet:
    """Fresh weights with the reference's initial distributions, drawn on the
    CPU from ``generator`` (leaf by leaf in sorted path order), then moved to
    ``device`` (``None``: the card)."""
    return SpikingNet(cfg, lambda path, spec: _draw(spec, generator), device)


def from_reference_params(params, cfg: SNNConfig, device=None) -> SpikingNet:
    """A :class:`SpikingNet` holding the reference's weights:
    ``params`` is a ``repro.models.specs.materialize(key, model_specs(cfg))``
    pytree as nested dicts of numpy arrays (HWIO conv weights). Raises on a
    missing or surplus leaf and on a wrong shape."""

    def check(spec_tree, tree, path):
        where = ".".join(path) or "params"
        if not isinstance(tree, Mapping):
            raise ValueError(f"{where}: expected a dict, got {type(tree)}")
        missing = sorted(set(spec_tree) - set(tree))
        surplus = sorted(set(tree) - set(spec_tree))
        if missing or surplus:
            raise ValueError(f"{where}: missing leaves {missing}, surplus "
                             f"leaves {surplus}")
        for k, v in spec_tree.items():
            if isinstance(v, ParamSpec):
                shape = tuple(np.shape(tree[k]))
                if shape != v.shape:
                    raise ValueError(f"{where}.{k}: shape {shape}, expected "
                                     f"{v.shape}")
            else:
                check(v, tree[k], path + (k,))

    check(model_specs(cfg), params, ())

    def leaf(path, spec):
        node = params
        for k in path:
            node = node[k]
        return torch.tensor(np.asarray(node), dtype=torch.float32)

    return SpikingNet(cfg, leaf, device)


def to_reference_params(net: SpikingNet, values=None) -> dict:
    """Nested dict of float32 numpy arrays in the reference's layout: the
    net's parameters, or ``values`` given one per parameter in
    ``net.parameters()`` order (gradients, say)."""
    named = list(net.named_parameters())
    values = [p for _, p in named] if values is None else list(values)
    if len(values) != len(named):
        raise ValueError(f"{len(values)} values for {len(named)} parameters")
    out: dict = {}
    for (name, _), v in zip(named, values):
        *groups, key = name.split(".")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[key] = _to_reference(v.detach()).float().cpu().numpy()
    return out


# ---- state / step ----------------------------------------------------------

def _shapes(cfg: SNNConfig, batch: int):
    """Walk descriptors tracking (H, W, C) to size LIF states. NHWC shapes,
    as the reference gives them."""
    h = w = cfg.in_res
    shapes = {}
    for b in cfg.blocks:
        if isinstance(b, ConvBNLif):
            h = -(-h // b.stride)
            w = -(-w // b.stride)
            if b.spike_out:
                shapes[b.name] = (batch, h, w, b.cout)
        elif isinstance(b, Residual):
            for u in b.body:
                h2 = -(-h // u.stride)
                w2 = -(-w // u.stride)
                if u.spike_out:
                    shapes[u.name] = (batch, h2, w2, u.cout)
                h, w = h2, w2
            shapes[b.name] = (batch, h, w, b.body[-1].cout)   # post-add LIF
        elif isinstance(b, MaxPool):
            h = -(-h // b.stride)
            w = -(-w // b.stride)
    return shapes


def init_state(cfg: SNNConfig, batch: int, dtype=torch.float32, device=None):
    """Per-LIF (membrane u, last spike s) carried across timesteps, zeros of
    NCHW shape ``[B, C, H, W]`` on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return {name: (torch.zeros((b, c, h, w), dtype=dtype, device=dev),
                   torch.zeros((b, c, h, w), dtype=dtype, device=dev))
            for name, (b, h, w, c) in _shapes(cfg, batch).items()}


def _apply_unit(p, u: ConvBNLif, x, state, new_state, lif: LIFConfig):
    y = L.conv2d(p["conv"], x, stride=u.stride)
    y = L.batch_norm(p["bn"], y)
    if u.spike_out:
        mu, ms = state[u.name]
        mu, s = lif_step(mu, ms, y, lif)
        new_state[u.name] = (mu, s)
        return s
    return y


def _step(params, cfg: SNNConfig, state, x):
    """One timestep on NCHW input."""
    new_state: dict = {}
    h = x
    logits = None
    for b in cfg.blocks:
        if isinstance(b, ConvBNLif):
            h = _apply_unit(params[b.name], b, h, state, new_state, cfg.lif)
        elif isinstance(b, Residual):
            r = h
            for u in b.body:
                r = _apply_unit(params[b.name][u.name], u, r, state, new_state,
                                cfg.lif)
            if b.downsample is not None:
                h = _apply_unit(params[b.name][b.downsample.name], b.downsample,
                                h, state, new_state, cfg.lif)
            y = r + h
            mu, ms = state[b.name]
            mu, s = lif_step(mu, ms, y, cfg.lif)
            new_state[b.name] = (mu, s)
            h = s
        elif isinstance(b, MaxPool):
            h = L.max_pool(h, b.k, b.stride)
        elif isinstance(b, Classifier):
            h = L.avg_pool_global(h)
            logits = L.linear(params[b.name], h)
    return new_state, logits


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def model_step(params, cfg: SNNConfig, state, x):
    """One timestep: x ``[B, H, W, C]`` (analog or spikes) -> (new_state,
    logits). ``state`` is NCHW, as :func:`init_state` makes it."""
    with L.fp32_convs():
        return _step(params, cfg, state, _nchw(x))


def model_rollout(params, cfg: SNNConfig, x):
    """x ``[B, H, W, C]`` static input (direct encoding), run for ``cfg.T``
    steps. Returns mean logits over time ``[B, n_classes]`` and the mean
    spike rate (aux)."""
    with L.fp32_convs():
        h = _nchw(x)
        state = init_state(cfg, x.shape[0], x.dtype, x.device)
        logits_t, rates = [], []
        for _ in range(cfg.T):
            state, logits = _step(params, cfg, state, h)
            rates.append(sum(s.mean() for (_, s) in state.values())
                         / max(len(state), 1))
            logits_t.append(logits)
        return torch.stack(logits_t).mean(0), torch.stack(rates).mean()
