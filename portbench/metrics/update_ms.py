"""update_ms (ms): device time a Lloyd iteration in everything but the
search kernels: the one-job update (the one-hot matrices and their
product, the new centroids, the shift), or the fused step's sums, pass 2
and the update from the partials."""

from portbench import kernel_names, tracing


def read(ctx):
    search = set(tracing.matching(ctx.trace.device, kernel_names.SEARCH))
    rest = [iv for iv in ctx.trace.device if iv not in search]
    iters = sum(j.counters.get("iterations", 0) for j in ctx.jobs)
    if not rest or not iters:
        return None
    return tracing.union_us(rest) / 1e3 / iters
