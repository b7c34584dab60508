"""xLSTM blocks (``repro.models.xlstm``): only the config so far.

The mLSTM and sLSTM cells are a later slice of the port (ROADMAP queue 1
item 10); a model that reaches one raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    up_factor: float = 2.0       # mLSTM projection expansion
    slstm_ff: float = 4.0 / 3.0  # sLSTM post-FFN expansion
    chunk: int = 64              # remat chunk length
