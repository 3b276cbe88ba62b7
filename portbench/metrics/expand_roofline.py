"""expand_roofline (%): the DBSCAN expansions' share of their roofline.

The least time of the window's expansions over the device time of the
expansion calls (what ``expand_ms`` takes: each call's packing of the
points, gather_frontier and neighbor_kernel).  The work follows the
algorithm, as ``work.degree`` counts it, from the program's counter of
the points the frontiers held (``frontier_points``, summed over the
window's expansions) and the expansions (``DBSCANResult.expansions``):

    operations = 2·d·n for each frontier point: its distance to each of
                 the n points, a subtract and a multiply-add a feature;
    bytes      = 4·n·d + 2·n for each expansion: the points read once,
                 the frontier's and the reached flags once.

The bound is the larger of the window's operations over the TF32 peak
and its bytes over the HBM bandwidth, which is at most the sum of each
expansion's own bound: the metric reads low, never high."""

from portbench import kernel_names, tracing, work


def frontier_points():
    """The program's count of the window's frontier points, or None where
    the program keeps no such counter."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.counts().get("frontier_points")


def read(ctx):
    ops = tracing.with_leads(ctx.trace.device, kernel_names.EXPAND,
                             kernel_names.NEIGHBOR_LEAD, kernel_names.DEGREE)
    points = frontier_points()
    expansions = sum(j.counters.get("expansions", 0) for j in ctx.jobs)
    if not ops or not points or not expansions:
        return None
    n, d = ctx.config["points"], ctx.config["features"]
    bound_s = work.roofline_s(2 * d * n * points,
                              expansions * (work.F32 * n * d + 2 * n))
    return 100.0 * bound_s / (tracing.union_us(ops) / 1e6)
