"""dbscan_mfu (%): the whole job's share of the card's peak: the degree's
work (``work.degree``) once a job over the traced window at the TF32
peak.  The expansions' work counts as nothing, so it reads low, never
high."""

from portbench import work


def read(ctx):
    if not ctx.jobs or not ctx.trace.device:
        return None
    c = ctx.config
    ops, _ = work.degree(c["points"], c["features"])
    return 100.0 * len(ctx.jobs) * ops / (ctx.trace.window_s
                                          * work.PEAK_TF32_FLOPS)
