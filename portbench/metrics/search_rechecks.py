"""search_rechecks (rechecks/pt): the exact rechecks of a job's last
search launch (``repro_torch.kernels.distance.ops.rechecks``' count) over
the points that launch searched, averaged over the window's jobs."""


def read(ctx):
    vals = [j.counters["rechecks"] / j.counters["recheck_rows"]
            for j in ctx.jobs if j.counters.get("rechecks") is not None]
    return sum(vals) / len(vals) if vals else None
