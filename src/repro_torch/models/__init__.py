"""The LM zoo's building blocks (``repro.models``): parameter specs, the
shared transformer layers, MLA, MoE and the decoder LM. The blocks of other
families (Mamba2, xLSTM, encoder-decoder) carry only their configs so far."""
from . import specs  # noqa: F401
