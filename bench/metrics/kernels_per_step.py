"""Kernels a training step: the CUDA kernels the traced window ran, over
its steps (copies and fills not counted)."""


def read(ctx):
    n = ctx.profile.kernel_count(ctx.trace)
    return n / ctx.steps if n else None
