"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit) and what ``nvidia-smi`` says of the card."""
from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12          # dense bf16 / fp16 tensor-core FLOP/s
HBM_BYTES = 3.35e12          # HBM3 bytes/s


def least_seconds(flops: float, nbytes: float):
    """``(seconds, bound)``: the larger of ``flops`` at the bf16 peak and
    ``nbytes`` at the HBM peak, and which of the two it is."""
    compute, memory = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return (compute, "compute") if compute >= memory else (memory, "memory")


def card_state() -> str:
    """The card's name, power limit and draw, SM clock and temperature,
    as ``nvidia-smi`` reads them ("not read" where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or f"not read ({out.stderr.strip()})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
