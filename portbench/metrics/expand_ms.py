"""expand_ms (ms): device time a job of the DBSCAN expansions: each
call's packing of the points, gather_frontier and neighbor_kernel."""

from portbench import kernel_names, tracing


def read(ctx):
    ops = tracing.with_leads(ctx.trace.device, kernel_names.EXPAND,
                             kernel_names.NEIGHBOR_LEAD, kernel_names.DEGREE)
    if not ops or not ctx.jobs:
        return None
    return tracing.union_us(ops) / 1e3 / len(ctx.jobs)
