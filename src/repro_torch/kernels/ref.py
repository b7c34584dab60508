"""The reference's oracles (``repro.kernels.ref``) under their names: the
plain PyTorch versions that sit beside each kernel, not second copies."""
from .flash_attention import flash_attention_plain as attention_ref  # noqa
from .lif import lif_step_plain as lif_ref  # noqa: F401
from .spike_matmul import spike_matmul_plain as spike_matmul_ref  # noqa: F401
