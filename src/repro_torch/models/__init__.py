"""The LM zoo's building blocks (``repro.models``): parameter specs, the
shared transformer layers and the decoder LM. The blocks of other families
(MLA, MoE, Mamba2, xLSTM, encoder-decoder) carry only their configs so far."""
from . import specs  # noqa: F401
