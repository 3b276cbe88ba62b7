"""dbscan_expansions (count): expansion launches a job
(``DBSCANResult.expansions``), averaged over the window's jobs."""


def read(ctx):
    vals = [j.counters["expansions"] for j in ctx.jobs
            if "expansions" in j.counters]
    return sum(vals) / len(vals) if vals else None
