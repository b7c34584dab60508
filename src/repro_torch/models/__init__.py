"""The LM zoo's building blocks (``repro.models``): parameter specs, the
shared transformer layers, MLA, MoE, Mamba2, xLSTM and the decoder LM. The
encoder-decoder family carries only its config so far."""
from . import specs  # noqa: F401
