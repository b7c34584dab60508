"""Spike-ResNet18 / Spike-VGG16 / Spike-ResNet50 descriptors (the paper's
workloads, §5.1).

An architecture is a descriptor list. The profiler (`snn.profile`) and the
partitioner walk the same descriptors. This module keeps the descriptors, the
constructors and the :class:`LIFConfig` they carry; the SNN forward pass of the
reference (``model_specs`` through ``model_rollout``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    threshold: float = 1.0
    decay: float = 0.5            # membrane leak λ
    reset: str = "hard"           # hard | soft
    surrogate: str = "rect"       # rect | sigmoid | atan
    surrogate_scale: float = 2.0  # window width / steepness α


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
