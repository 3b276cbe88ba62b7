"""The traced run: ``torch.profiler`` over the window, reduced to device
intervals, the device's busy time, and a breakdown.

Device operations (kernels, copies, sets) come from the profiler's
device trace; the host's operations and the benchmark's own spans
(``record_function`` around each job and around the window) label the
gaps in which the card had nothing to do.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."

Interval = Tuple[str, float, float]   # (name, start us, end us)


@dataclasses.dataclass
class Trace:
    """What the window's trace holds, in microseconds of the trace's
    clock: device operations and host operations, each sorted by start,
    and the window's bounds."""

    device: List[Interval]
    host: List[Interval]
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us(self.device) / 1e6


def span(name: str):
    """A span of the benchmark's own, named ``portbench.<what>``."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(enabled: bool):
    """The profiler over the block (CPU and CUDA activities) or nothing;
    yields the profiler or None."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def warm_profiler() -> None:
    """The profiler's first session sets itself up (seconds): spend that
    in set-up."""
    with profiled(True):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def read(prof) -> Trace:
    """The window's device and host operations from a finished profile."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    start = end = None
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            # a span shows on the device's timeline too: not an operation
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                device.append(iv)
        else:
            host.append(iv)
            if e.name == WINDOW:
                start, end = iv[1], iv[2]
    if start is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    by_start = lambda iv: (iv[1], iv[2])
    device = sorted((iv for iv in device if iv[2] > start and iv[1] < end),
                    key=by_start)
    host = sorted((iv for iv in host if iv[2] > start and iv[1] < end
                   and iv[0] != WINDOW), key=by_start)
    return Trace(device, host, start, end)


def merged(intervals: Iterable[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end)."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda iv: iv[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_us(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in merged(intervals))


def matching(ops: Sequence[Interval], names: Iterable[str]
             ) -> List[Interval]:
    """The operations whose name holds one of ``names`` as a word (a
    kernel's name is its demangled signature)."""
    keys = tuple(names)
    return [iv for iv in ops if any(_has_name(iv[0], k) for k in keys)]


def _has_name(full: str, name: str) -> bool:
    i = full.find(name)
    while i >= 0:
        before = full[i - 1] if i else " "
        after = full[i + len(name)] if i + len(name) < len(full) else " "
        if not (before.isalnum() or before == "_") and not (
                after.isalnum() or after == "_"):
            return True
        i = full.find(name, i + 1)
    return False


def with_leads(ops: Sequence[Interval], members: Iterable[str],
               lead: str, others: Iterable[str]) -> List[Interval]:
    """The operations named in ``members``, each with the ``lead``
    operations (a packing kernel that every call of the library launches
    first) that ran since the library's previous named kernel.  A lead
    followed by a kernel of ``others`` belongs to that call instead."""
    members, others = tuple(members), tuple(others)
    out: List[Interval] = []
    pending: List[Interval] = []
    for iv in ops:
        if _has_name(iv[0], lead):
            pending.append(iv)
        elif any(_has_name(iv[0], m) for m in members):
            out += pending + [iv]
            pending = []
        elif any(_has_name(iv[0], o) for o in others):
            pending = []
    return out


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing in them (the innermost host
    operation or span running at the gap's middle)."""
    by_op: dict = {}
    for name, a, b in trace.device:
        key = _short(name)
        by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e6
    busy = merged(trace.device)
    gaps, t = [], trace.start
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, trace.end)))
        t = max(t, b)
    if t < trace.end:
        gaps.append((t, trace.end))
    by_host: dict = {}
    names = _hosts_at(trace.host, [(a + b) / 2 for a, b in gaps])
    for (a, b), name in zip(gaps, names):
        key = _short(name or "(no host op)")
        by_host[key] = by_host.get(key, 0.0) + (b - a) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def _hosts_at(host: Sequence[Interval], times: Sequence[float]
              ) -> List[Optional[str]]:
    """For each of the ascending ``times``, the host operation running
    then that started last (the innermost), or None."""
    out: List[Optional[str]] = []
    active: List[Interval] = []
    i = 0
    for t in times:
        while i < len(host) and host[i][1] <= t:
            active.append(host[i])
            i += 1
        active = [iv for iv in active if iv[2] >= t]
        out.append(max(active, key=lambda iv: iv[1])[0] if active else None)
    return out
