"""Share of the flash backward's roofline, in %: the least time the step's
attention backward calls need over the device time of the backward
kernels (``flash_bwd*``: pre-pass, dK/dV, dQ).

FLOPs: the backward's five products over the visible pairs (QK^T again,
dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q), 5·B·H·S²·D a causal
call. Bytes: q, k, v, the output, dO and the log-sum-exp read once, dq,
dk, dv written once. Calls are the model's, one a layer; the backward
launch counter is printed beside them.
"""


def call_cost(c):
    b, h, hkv, s, d, elt = c["B"], c["H"], c["Hkv"], c["S"], c["D"], c["elt"]
    flops = (5 if c["causal"] else 10) * b * h * s * s * d
    nbytes = elt * (4 * b * s * h * d + 4 * b * s * hkv * d) + 4 * b * h * s
    return flops, nbytes


def read(ctx):
    dev = ctx.profile.matching_seconds(ctx.trace, lambda n: "flash_bwd" in n)
    if not dev:
        return None
    least, bounds, calls = 0.0, set(), 0
    for c in ctx.flash_calls:
        t, bound = ctx.peaks.least_seconds(*call_cost(c))
        least += t * c["bwd"] * ctx.steps
        bounds.add(bound)
        calls += c["bwd"] * ctx.steps
    ctx.log(f"flash backward: {calls} calls by the model, "
            f"{ctx.counters.get('flash_bwd_launches')} launches counted; "
            f"least {least!r} s ({'/'.join(sorted(bounds))}-bound) against "
            f"{dev!r} s on the device")
    return 100.0 * least / dev
