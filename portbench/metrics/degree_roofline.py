"""degree_roofline (%): the DBSCAN degree's share of its roofline.

The least time of the window's degrees (``work.degree``, once a job) over
the device time of the degree calls: degree_tri_kernel and the packing
of the points that the call launched first."""

from portbench import kernel_names, tracing, work


def read(ctx):
    ops = tracing.with_leads(ctx.trace.device, kernel_names.DEGREE,
                             kernel_names.NEIGHBOR_LEAD, kernel_names.EXPAND)
    if not ops or not ctx.jobs:
        return None
    c = ctx.config
    bound_s = work.roofline_s(*work.degree(c["points"], c["features"]))
    return 100.0 * len(ctx.jobs) * bound_s / (tracing.union_us(ops) / 1e6)
