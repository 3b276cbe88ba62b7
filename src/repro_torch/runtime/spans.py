"""Program spans and counters on the profiler's clock.

``span(name)`` records the range ``name`` while a ``torch.profiler``
session records, so it lands in the profile beside the device's
operations; otherwise it is one shared no-op context and nothing is
recorded.  The range is the profiler's fast record
(``torch._C._profiler._RecordFunctionFast``, what compiled code records
its kernels with): a host range like an operator's, 1.6-2.8 us to enter
and leave under the profiler on an H100's host, where
``torch.profiler.record_function`` takes 14-16 us and adds a device-side
annotation that the benchmark's trace drops.  ``count(name, n)`` adds to
a table of integer counts, also only while a session records.  The
profiler being on is the only switch: there is no setting, variable or
thread.

A profiled stretch's counts start from zero: the first count under a
profiler clears the table where a call of this module (a span, a count, a
read, or :func:`counts` itself) has seen the profiler off since the
table's last count.  So the table holds the last stretch's counts, to be
read after the profiler stops, until the next stretch counts something.

``read(t)`` is how the solver loops read a device scalar to the host: the
same ``.item()``, inside a ``repro_torch.sync`` span, counted as one of
``host_syncs``; ``synced(fn, ...)`` spans and counts any other call that
makes the host wait on the card.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

SYNC = "repro_torch.sync"

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_counts: Dict[str, int] = {}
# the profiler was seen off since the table's last count
_stale = True


def _recording() -> bool:
    global _stale
    if torch.autograd._profiler_enabled():
        return True
    _stale = True
    return False


def span(name: str):
    """A context over the block: the profiler's range ``name`` while a
    profiler records, else a shared no-op."""
    if _recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler records."""
    global _stale
    if not _recording():
        return
    with _lock:
        if _stale:
            _counts.clear()
            _stale = False
        _counts[name] = _counts.get(name, 0) + int(n)


def counts() -> Dict[str, int]:
    """A copy of the table: the counts of the last profiled stretch."""
    _recording()
    with _lock:
        return dict(_counts)


def synced(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call in which the host waits on the card
    once, spanned and counted as one of ``host_syncs``."""
    with span(SYNC):
        value = fn(*args, **kwargs)
    count("host_syncs")
    return value


def read(t: torch.Tensor):
    """``t.item()``: one device-to-host read, spanned and counted."""
    return synced(t.item)
