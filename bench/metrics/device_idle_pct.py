"""Share of the traced window, in %, in which no operation runs on the
device: one minus the union of the device's kernel, copy and fill
intervals over the window's length (the ``bench.window`` host span, from
the first step's hand-off to the last synchronise)."""


def read(ctx):
    window = ctx.trace.window[1] - ctx.trace.window[0]
    busy = ctx.profile.busy_ns(ctx.trace)
    if not busy or window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
