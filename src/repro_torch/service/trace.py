"""Span-based per-request tracing: where did *this* request spend its time.

The paper's whole argument is measurement — runtime per paradigm times a
constant active power is the energy story (Fig. 9) — but the service's
windowed percentiles can only answer "what is p50 overall", not "why was
request 4312 slow".  This module adds the per-request axis: a *trace* is
minted at ``submit`` (one id per request, persisted in the WAL entry and
in the durable job record so it survives process death), and every stage
the request passes through — precheck, WAL append, queue wait, batch
formation, plan selection, each execute attempt, checkpoints, delivery —
emits a *span* into a bounded ring buffer.

Design:

- **Spans are cheap and immutable.**  A span is (trace_id, name, wall
  start, duration, pid/tid, attrs).  Durations are measured on the
  monotonic clock; the wall timestamp is only for display alignment.
- **Bounded ring.**  Completed spans land in a ``deque(maxlen=capacity)``;
  overflow evicts the oldest and counts ``dropped`` — a long-lived
  service never grows tracing state without bound.
- **Crash continuity via the sink.**  Every completed span (and, for
  long-running execute attempts, a ``span_start`` announcement) is also
  handed to an optional ``sink`` callback — the service wires it to the
  rotating JSONL event log, whose flushed lines survive SIGKILL.  A
  request preempted mid-batch therefore has its first attempt's spans on
  disk, and the process that resumes the batch continues the *same*
  trace id (recovered from the job record / WAL entry):
  :func:`read_spans` merges both lifetimes back into one trace.
- **Chrome trace export.**  :func:`chrome_trace` renders spans as the
  ``trace_event`` JSON that chrome://tracing / Perfetto load directly,
  so a service run becomes a flame graph.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional

# Default ring capacity: at ~8 spans per request this holds the last ~500
# requests' traces — enough to inspect recent latency without unbounded
# growth (evictions are counted, and the JSONL sink keeps the long tail).
DEFAULT_CAPACITY = 4096

_SPAN_IDS = itertools.count(1)


def new_trace_id() -> str:
    """Mint a globally-unique trace id (16 hex chars, no coordination)."""
    return os.urandom(8).hex()


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed stage of one request's journey."""

    trace_id: str
    name: str                  # stage: wal_append, queue_wait, execute, ...
    t0: float                  # wall-clock start (epoch seconds)
    dur_s: float               # measured on the monotonic clock
    span_id: str = ""
    pid: int = 0
    tid: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "t0": self.t0,
            "dur_s": self.dur_s,
            "pid": self.pid,
            "tid": self.tid,
            "attrs": dict(self.attrs),
            "phase": "complete",
        }


def _new_span_id() -> str:
    return f"{os.getpid():x}-{next(_SPAN_IDS)}"


class SpanHandle:
    """In-flight span: created by :meth:`RequestTracer.begin`, completed by
    :meth:`finish` (or by exiting it as a context manager — an exception
    completes the span with an ``error`` attr and propagates)."""

    def __init__(self, tracer: "RequestTracer", trace_id: str, name: str,
                 attrs: Dict[str, Any], announce: bool) -> None:
        self._tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.attrs = attrs
        self.span_id = _new_span_id()
        self.t0 = time.time()
        self._t0_mono = time.monotonic()
        self._done = False
        if announce:
            # journal the start: if this process dies mid-span (SIGKILL),
            # the flushed start event is the only evidence the attempt ran
            tracer._sink_event("span_start", {
                "trace_id": trace_id, "span_id": self.span_id,
                "name": name, "t0": self.t0, "dur_s": None,
                "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF,
                "attrs": dict(attrs), "phase": "start",
            })

    def finish(self, **attrs: Any) -> Optional[Span]:
        if self._done:
            return None
        self._done = True
        merged = dict(self.attrs)
        merged.update(attrs)
        return self._tracer.emit(
            self.trace_id, self.name, self.t0,
            time.monotonic() - self._t0_mono,
            span_id=self.span_id, **merged)

    def __enter__(self) -> "SpanHandle":
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        if exc is not None:
            self.finish(error=repr(exc))
        else:
            self.finish()


class RequestTracer:
    """Thread-safe bounded span collector with an optional durable sink.

    ``sink(event, payload)`` is called (outside the ring lock) with
    ``("span", span_dict)`` for every completed span and
    ``("span_start", ...)`` for announced long-running spans; the service
    points it at the JSONL event log and the stage-latency metrics.  A
    raising sink is swallowed — telemetry must never take the request
    path down.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sink: Optional[Callable[[str, Dict[str, Any]], None]] = None,
                 ) -> None:
        self.capacity = max(1, int(capacity))
        self.sink = sink
        self._lock = threading.Lock()
        self._spans: Deque[Span] = deque(maxlen=self.capacity)
        self.dropped = 0           # ring evictions (oldest span lost)
        self.emitted = 0           # completed spans ever recorded

    # -- emission ------------------------------------------------------------

    def _sink_event(self, event: str, payload: Dict[str, Any]) -> None:
        if self.sink is None:
            return
        try:
            self.sink(event, payload)
        except Exception:
            pass

    def emit(self, trace_id: str, name: str, t0: float, dur_s: float,
             span_id: Optional[str] = None, **attrs: Any) -> Span:
        """Record a completed span (retroactive timestamps allowed — the
        queue-wait span is emitted at batch-claim time from the request's
        own submit/stage timestamps)."""
        span = Span(trace_id=trace_id, name=name, t0=float(t0),
                    dur_s=max(0.0, float(dur_s)),
                    span_id=span_id or _new_span_id(),
                    pid=os.getpid(),
                    tid=threading.get_ident() & 0xFFFF,
                    attrs=attrs)
        with self._lock:
            if len(self._spans) >= self.capacity:
                self.dropped += 1
            self._spans.append(span)
            self.emitted += 1
        self._sink_event("span", span.as_dict())
        return span

    def mark(self, trace_id: str, name: str, **attrs: Any) -> Span:
        """Zero-duration marker span (e.g. the resume boundary)."""
        return self.emit(trace_id, name, time.time(), 0.0, **attrs)

    def begin(self, trace_id: str, name: str, announce: bool = False,
              **attrs: Any) -> SpanHandle:
        """Open an in-flight span; ``announce=True`` journals the start to
        the sink so a SIGKILL mid-span still leaves evidence on disk."""
        return SpanHandle(self, trace_id, name, attrs, announce)

    # -- inspection ----------------------------------------------------------

    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            snapshot = list(self._spans)
        if trace_id is None:
            return snapshot
        return [s for s in snapshot if s.trace_id == trace_id]

    def export(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        return [s.as_dict() for s in self.spans(trace_id)]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            spans = list(self._spans)
            return {
                "capacity": self.capacity,
                "spans": len(spans),
                "emitted": self.emitted,
                "dropped": self.dropped,
                "traces": len({s.trace_id for s in spans}),
            }


# -- export / cross-process merge ---------------------------------------------


def chrome_trace(spans: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Render span dicts as Chrome ``trace_event`` JSON (load the file in
    chrome://tracing or https://ui.perfetto.dev for a flame graph).

    Completed spans become ``X`` (complete) events; ``span_start``
    journal entries whose completion never landed (the process died
    mid-span) become unmatched ``B`` (begin) events, which the viewers
    render as open-ended slices — exactly what they were.
    """
    events: List[Dict[str, Any]] = []
    for s in spans:
        ev = {
            "name": s["name"],
            "cat": "service",
            "ts": float(s["t0"]) * 1e6,          # microseconds
            "pid": int(s.get("pid", 0)),
            "tid": int(s.get("tid", 0)),
            "args": dict(s.get("attrs") or {}, trace_id=s["trace_id"]),
        }
        if s.get("phase") == "start" or s.get("dur_s") is None:
            ev["ph"] = "B"
        else:
            ev["ph"] = "X"
            ev["dur"] = float(s["dur_s"]) * 1e6
        events.append(ev)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def read_spans(events_root: str,
               trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Recover span dicts from a JSONL event-log directory.

    Merges every ``span`` / ``span_start`` event across all rotated
    files — and therefore across *process lifetimes*: the trace of a
    request whose first execute attempt died to SIGKILL and whose second
    attempt ran in the recovery process comes back as one span list.  A
    ``span_start`` superseded by its completion is dropped; one whose
    completion never landed (the attempt died mid-span) survives with
    ``phase == "start"``.
    """
    merged: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    try:
        names = sorted(n for n in os.listdir(events_root)
                       if n.startswith("events-") and n.endswith(".jsonl"))
    except OSError:
        return []
    for name in names:
        try:
            f = open(os.path.join(events_root, name), "r")
        except OSError:
            continue
        with f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue               # torn tail of a killed writer
                if rec.get("event") not in ("span", "span_start"):
                    continue
                if trace_id is not None and rec.get("trace_id") != trace_id:
                    continue
                sid = str(rec.get("span_id"))
                prior = merged.get(sid)
                if prior is None:
                    order.append(sid)
                elif prior.get("phase") == "complete":
                    continue               # completion beats its start
                merged[sid] = {
                    "trace_id": rec.get("trace_id"),
                    "span_id": sid,
                    "name": rec.get("name"),
                    "t0": rec.get("t0"),
                    "dur_s": rec.get("dur_s"),
                    "pid": rec.get("pid", 0),
                    "tid": rec.get("tid", 0),
                    "attrs": rec.get("attrs") or {},
                    "phase": rec.get("phase", "complete"),
                }
    out = [merged[sid] for sid in order]
    out.sort(key=lambda s: (s.get("t0") or 0.0))
    return out
