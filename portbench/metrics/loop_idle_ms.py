"""loop_idle_ms (ms): device-idle time a job inside the program's fit
spans (``repro_torch.kmeans.fit``, ``repro_torch.dbscan.fit``): the card
waiting on the solver's host loop, its kernel wrappers and its reads.
Idle is where the union of the device's operations
(``tracing.merged(ctx.trace.device)``) leaves a fit span uncovered."""

import bisect

from portbench import tracing

FITS = ("repro_torch.kmeans.fit", "repro_torch.dbscan.fit")


def idle_us(busy, starts, a: float, b: float) -> float:
    """The part of [a, b] that the sorted disjoint ``busy`` (their
    ``starts``) leaves free."""
    covered = 0.0
    i = max(0, bisect.bisect_right(starts, a) - 1)
    while i < len(busy) and busy[i][0] < b:
        covered += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return (b - a) - covered


def read(ctx):
    fits = [iv for iv in ctx.trace.host if iv[0] in FITS]
    if not fits or not ctx.jobs or not ctx.trace.device:
        return None
    busy = tracing.merged(ctx.trace.device)
    starts = [a for a, _ in busy]
    idle = sum(idle_us(busy, starts, a, b)
               for a, b in tracing.merged(fits))
    return idle / 1e3 / len(ctx.jobs)
