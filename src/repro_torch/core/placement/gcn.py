"""Graph-convolution encoder (paper §4.3, Fig 5b/5c front-end).

Two GCN layers over the normalized Laplacian:  H' = relu(L̂ H W + b). Weights
are kept as ``[in, out]`` (``x @ W``), the reference's layout, so reference
parameters carry over unchanged.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def normal_param(shape, std: float, generator=None) -> nn.Parameter:
    """``std × N(0, 1)`` float32 draws from ``generator`` (on the CPU)."""
    return nn.Parameter(std * torch.randn(shape, generator=generator,
                                          dtype=torch.float32))


def fan_in_param(shape, generator=None) -> nn.Parameter:
    """The reference's default init: normal with std ``1/sqrt(fan_in)``,
    ``fan_in = shape[0]``."""
    return normal_param(shape, 1.0 / math.sqrt(max(shape[0], 1)), generator)


class GCN(nn.Module):
    """``lap [n, n], x [n, d_in] -> [n, d_hidden]``; parameters ``w{i}``
    ``[in, out]`` and ``b{i}`` (zeros at init)."""

    def __init__(self, d_in: int, d_hidden: int, n_layers: int = 2,
                 generator=None):
        super().__init__()
        self.n_layers = n_layers
        d = d_in
        for i in range(n_layers):
            self.register_parameter(f"w{i}", fan_in_param((d, d_hidden),
                                                          generator))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros(d_hidden)))
            d = d_hidden

    def forward(self, lap, x):
        h = x
        for i in range(self.n_layers):
            h = lap @ h @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            h = torch.relu(h)
        return h
