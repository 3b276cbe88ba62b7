"""device_idle (%): the share of the traced window in which the profiler
shows no kernel, copy or set on the card."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
