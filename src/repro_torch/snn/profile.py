"""Per-layer cost profiles feeding the partitioner (paper §4.2 step 1:
"calculate computational operations and memory requirements of each layer").

Spike-specific accounting:
* forward conv on binary spikes = accumulate-only ops (the FP engine's
  selector+adder), counted as ``flops × spike_density`` effective ACs;
* inter-layer traffic is spike *bits*, not FP16 activations (1 bit/neuron/step),
  except the analog stem input;
* training triples the pass count (FP + BP + WG, Fig 3), with BP/WG on FP16 data.
"""
from __future__ import annotations

from ..core.partition import LayerProfile
from .models import Classifier, ConvBNLif, MaxPool, Residual, SNNConfig


def _conv_profile(u: ConvBNLif, h: int, w: int, T: int, spike_density: float,
                  training: bool, batch: int):
    ho, wo = -(-h // u.stride), -(-w // u.stride)
    macs = ho * wo * u.cin * u.cout * u.k * u.k
    fwd = 2.0 * macs * spike_density            # ACs on spiking inputs
    flops = fwd
    if training:
        flops += 2 * 2.0 * macs                 # BP (dense) + WG passes
    out_bits = ho * wo * u.cout                 # 1 spike bit per neuron
    out_bytes = out_bits / 8.0
    if training:                                # BP sends FP16 grads back
        out_bytes += ho * wo * u.cout * 2.0
    return (flops * T * batch,
            u.k * u.k * u.cin * u.cout * 2.0,   # FP16 weights
            out_bytes * T * batch, ho, wo)


def profile_model(cfg: SNNConfig, batch: int = 1, spike_density: float = 0.15,
                  training: bool = True):
    """Returns list[LayerProfile]; one entry per conv/fc unit (BN folded in)."""
    h = w = cfg.in_res
    profiles = []

    def add_unit(u: ConvBNLif, h, w):
        flops, wbytes, obytes, ho, wo = _conv_profile(
            u, h, w, cfg.T, spike_density, training, batch)
        profiles.append(LayerProfile(u.name, flops, wbytes, obytes,
                                     c_in=u.cin, c_out=u.cout))
        return ho, wo

    for b in cfg.blocks:
        if isinstance(b, ConvBNLif):
            h, w = add_unit(b, h, w)
        elif isinstance(b, Residual):
            hh, ww = h, w
            for u in b.body:
                hh, ww = add_unit(u, hh, ww)
            if b.downsample is not None:
                add_unit(b.downsample, h, w)
            h, w = hh, ww
        elif isinstance(b, MaxPool):
            h, w = -(-h // b.stride), -(-w // b.stride)
        elif isinstance(b, Classifier):
            flops = 2.0 * b.din * b.dout * cfg.T * batch
            if training:
                flops *= 3
            profiles.append(LayerProfile(b.name, flops, b.din * b.dout * 2.0,
                                         b.dout * 2.0 * cfg.T * batch,
                                         c_in=b.din, c_out=b.dout))
    return profiles
