"""Device milliseconds a step in the cuBLAS GEMM kernels (the
projections, the MLP and the chunked CE head), matched by name."""

NAMES = ("gemm", "nvjet", "xmma", "cutlass", "splitkreduce", "cublas")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return "flash" not in low and any(n in low for n in NAMES)


def read(ctx):
    s = ctx.profile.matching_seconds(ctx.trace, is_gemm)
    return s * 1e3 / ctx.steps if s else None
