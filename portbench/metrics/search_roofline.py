"""search_roofline (%): the K-Means search's share of its roofline.

The least time of the window's searches (``work.search`` of the whole
dataset, once per Lloyd iteration) over the time in which a search
kernel ran on the card (the union of their intervals, so shards that run
side by side are not counted twice)."""

from portbench import kernel_names, tracing, work


def read(ctx):
    ops = tracing.matching(ctx.trace.device, kernel_names.SEARCH)
    iters = sum(j.counters.get("iterations", 0) for j in ctx.jobs)
    if not ops or not iters:
        return None
    c = ctx.config
    bound_s = work.roofline_s(*work.search(c["points"], c["k"],
                                           c["features"]))
    return 100.0 * iters * bound_s / (tracing.union_us(ops) / 1e6)
