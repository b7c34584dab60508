"""Share of the flash forward's roofline, in %: the least time the step's
forward attention calls need on the card over the device time of the
forward kernels (``flash_fwd*``).

The least time of a call is the larger of its FLOPs at the bf16 peak and
its bytes at the HBM peak. FLOPs: QK^T and PV over the visible pairs,
2·B·H·S²·D a causal call (4·B·H·S²·D without a mask). Bytes: q, k, v read
once, the output and its log-sum-exp written once. The calls are the
model's (its attention layers, each recomputed once under remat),
whatever kernels carry them; the forward launch counter is printed beside
them as a cross-check.
"""


def call_cost(c):
    b, h, hkv, s, d, elt = c["B"], c["H"], c["Hkv"], c["S"], c["D"], c["elt"]
    flops = (2 if c["causal"] else 4) * b * h * s * s * d
    nbytes = elt * (2 * b * s * h * d + 2 * b * s * hkv * d) + 4 * b * h * s
    return flops, nbytes


def read(ctx):
    dev = ctx.profile.matching_seconds(ctx.trace, lambda n: "flash_fwd" in n)
    if not dev:
        return None
    least, bounds, calls = 0.0, set(), 0
    for c in ctx.flash_calls:
        t, bound = ctx.peaks.least_seconds(*call_cost(c))
        least += t * c["fwd"] * ctx.steps
        bounds.add(bound)
        calls += c["fwd"] * ctx.steps
    ctx.log(f"flash forward: {calls} calls by the model, "
            f"{ctx.counters.get('flash_fwd_launches')} launches counted; "
            f"least {least!r} s ({'/'.join(sorted(bounds))}-bound) against "
            f"{dev!r} s on the device")
    return 100.0 * least / dev
