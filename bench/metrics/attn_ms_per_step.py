"""Device milliseconds a step in the port's flash attention kernels: the
forward (with its recomputation under remat) and the backward's pre-pass,
dK/dV and dQ kernels, matched by name."""


def is_flash(name: str) -> bool:
    return "flash_fwd" in name or "flash_bwd" in name


def read(ctx):
    s = ctx.profile.matching_seconds(ctx.trace, is_flash)
    return s * 1e3 / ctx.steps if s else None
