"""kmeans_mfu (%): the whole Lloyd step's share of the card's peak, the
window's work (``work.lloyd_step_flops`` once per iteration) over the
traced window at the TF32 peak."""

from portbench import work


def read(ctx):
    iters = sum(j.counters.get("iterations", 0) for j in ctx.jobs)
    if not iters or not ctx.trace.device:
        return None
    c = ctx.config
    flops = iters * work.lloyd_step_flops(c["points"], c["k"], c["features"])
    return 100.0 * flops / (ctx.trace.window_s * work.PEAK_TF32_FLOPS)
