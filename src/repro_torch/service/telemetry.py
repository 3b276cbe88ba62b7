"""Telemetry export: Prometheus scrape, durable event log, SLO burn rate.

Three pieces, all consuming the same ``metrics_snapshot()`` the service
already produces:

- :func:`render_prometheus` flattens a snapshot into Prometheus text
  exposition format 0.0.4 — the lingua franca of fleet scrapers — and
  :class:`TelemetryServer` serves it from a background HTTP thread
  (``/metrics``, plus ``/trace`` for the span ring and ``/snapshot`` for
  the raw JSON).  No third-party client library: the format is plain
  text and this module emits it directly.
- :class:`EventLog` is a rotating JSONL structured log (batch outcomes,
  rejections, suspensions, WAL compactions, spans).  Lines are written
  and *flushed* per event: a SIGKILL'd process loses at most the line
  being formatted, which is what makes cross-process trace recovery
  (``trace.read_spans``) work.  Rotation is by size with a bounded file
  count, so the log — like every other on-disk artifact here — cannot
  grow without bound.
- :class:`SLOEvaluator` turns the windowed latency/error observations
  into burn rates: observed bad-fraction divided by the budgeted
  bad-fraction.  Burn rate 1.0 means "consuming exactly the error
  budget"; >1 means the target will be violated if the window is
  representative.  Surfaced as ``metrics_snapshot()["slo"]`` and as
  ``repro_slo_burn_rate`` series for alerting.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

from .metrics import percentile
from . import trace as trace_mod

# -- Prometheus text exposition ----------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"                       # metric name
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\",?)*)\})?"
    r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN|\+Inf)$")


def _esc(value: Any) -> str:
    """Escape a label value per the exposition format."""
    return (str(value).replace("\\", "\\\\")
            .replace("\n", "\\n").replace('"', '\\"'))


def _num(value: Any) -> str:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


class _Lines:
    """Accumulates samples grouped by metric family with HELP/TYPE."""

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix
        self._out: List[str] = []
        self._seen: set = set()

    def add(self, name: str, value: Any, labels: Optional[Dict[str, Any]] = None,
            help_text: str = "", kind: str = "gauge") -> None:
        full = f"{self.prefix}_{name}"
        if not _NAME_RE.match(full):
            return
        if full not in self._seen:
            self._seen.add(full)
            self._out.append(f"# HELP {full} {help_text or full}")
            self._out.append(f"# TYPE {full} {kind}")
        if labels:
            lab = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
            self._out.append(f"{full}{{{lab}}} {_num(value)}")
        else:
            self._out.append(f"{full} {_num(value)}")

    def text(self) -> str:
        return "\n".join(self._out) + "\n"


def render_prometheus(snapshot: Dict[str, Any], prefix: str = "repro") -> str:
    """Flatten a ``metrics_snapshot()`` dict into exposition text.

    Tolerates missing blocks (older snapshots, partial services): absent
    keys simply emit no series.  Deterministic ordering so scrapes diff
    cleanly.
    """
    out = _Lines(prefix)

    # request/batch totals -----------------------------------------------
    totals = snapshot.get("totals") or {}
    for key, name, help_text in (
            ("requests", "requests_total",
             "Requests completed (incl. cache hits)"),
            ("cache_hits", "cache_hits_total",
             "Requests resolved from the result cache"),
            ("batches", "batches_total", "Micro-batches executed"),
            ("failures", "failures_total", "Requests finished with an error"),
            ("modeled_joules", "modeled_joules_total",
             "Modeled energy across all batches"),
    ):
        if key in totals:
            out.add(name, totals[key], help_text=help_text, kind="counter")

    for key, name, kind, help_text in (
            ("queue_depth", "queue_depth", "gauge",
             "Requests currently queued"),
            ("queue_rejected", "queue_rejected_total", "counter",
             "Admissions rejected at the door"),
            ("queue_expired", "queue_expired_total", "counter",
             "Requests expired in the queue"),
            ("queue_rate_limited", "queue_rate_limited_total", "counter",
             "Admissions bounced by the tenant token bucket"),
            ("queue_too_large", "queue_too_large_total", "counter",
             "Admissions bounced as over the device budget"),
            ("p50_latency_s", "p50_latency_seconds", "gauge",
             "p50 request latency over the window"),
            ("p99_latency_s", "p99_latency_seconds", "gauge",
             "p99 request latency over the window"),
            ("p50_queue_wait_s", "p50_queue_wait_seconds", "gauge",
             "p50 admission-to-claim wait over the window"),
            ("mean_occupancy", "mean_occupancy", "gauge",
             "Mean batch slot occupancy"),
            ("mean_batch_size", "mean_batch_size", "gauge",
             "Mean executed batch size"),
            ("suspended_batches", "suspended_batches_total", "counter",
             "Batches parked SUSPENDED by preemption"),
            ("resumed_batches", "resumed_batches_total", "counter",
             "Suspended batches resumed to completion"),
    ):
        if key in snapshot:
            out.add(name, snapshot[key], help_text=help_text, kind=kind)

    errors = snapshot.get("errors") or {}
    if "window_error_rate" in errors:
        out.add("window_error_rate", errors["window_error_rate"],
                help_text="Failed fraction of windowed request outcomes")
    for reason, count in sorted((errors.get("by_reason") or {}).items()):
        out.add("failures_by_reason_total", count,
                labels={"reason": reason},
                help_text="Request failures by exception type",
                kind="counter")

    # per-executor -------------------------------------------------------
    for ex, stats in sorted((snapshot.get("by_executor") or {}).items()):
        lab = {"executor": ex}
        for key, name, kind in (
                ("batches", "executor_batches_total", "counter"),
                ("requests", "executor_requests_total", "counter"),
                ("exec_s", "executor_exec_seconds_total", "counter"),
                ("host_s", "executor_host_seconds_total", "counter"),
                ("device_s", "executor_device_seconds_total", "counter"),
                ("modeled_joules", "executor_modeled_joules", "counter"),
                ("joules_per_work", "executor_joules_per_work", "gauge"),
                ("mean_occupancy", "executor_mean_occupancy", "gauge"),
                ("suspended", "executor_suspended_total", "counter"),
        ):
            if isinstance(stats, dict) and key in stats:
                out.add(name, stats[key], labels=lab,
                        help_text=f"Per-executor {key}", kind=kind)

    # per-stage latency breakdown ---------------------------------------
    for stage, stats in sorted((snapshot.get("stages") or {}).items()):
        if not isinstance(stats, dict):
            continue
        scopes = [(stats, {"stage": stage, "executor": ""})]
        for ex, sub in sorted((stats.get("by_executor") or {}).items()):
            scopes.append((sub, {"stage": stage, "executor": ex}))
        for stats_d, lab in scopes:
            out.add("stage_latency_count", stats_d.get("count", 0), labels=lab,
                    help_text="Spans observed per stage (window)", kind="counter")
            for q in ("p50", "p99"):
                key = f"{q}_s"
                if key in stats_d:
                    out.add("stage_latency_seconds", stats_d[key],
                            labels=dict(lab, quantile=q),
                            help_text="Stage latency quantiles (window)")

    # bucketing / cache / wal -------------------------------------------
    bucketing = snapshot.get("bucketing") or {}
    for key, kind in (("recompiles", "counter"),
                      ("shape_evictions", "counter"),
                      ("tracked_shapes", "gauge"),
                      ("max_tracked_shapes", "gauge"),
                      ("padding_waste", "gauge"),
                      ("point_occupancy", "gauge")):
        if key in bucketing:
            out.add(f"bucketing_{key}", bucketing[key],
                    help_text=f"Bucketing {key}", kind=kind)
    cache = snapshot.get("cache") or {}
    for key in ("entries", "hits", "misses", "disk_hits"):
        if key in cache:
            kind = "gauge" if key == "entries" else "counter"
            out.add(f"cache_{key}", cache[key],
                    help_text=f"Result cache {key}", kind=kind)
    wal = snapshot.get("wal") or {}
    for key, kind in (("segments", "gauge"), ("pending", "gauge"),
                      ("consumed", "gauge"), ("appended", "counter"),
                      ("fsyncs", "counter"),
                      ("compacted_segments", "counter")):
        if key in wal:
            out.add(f"wal_{key}", wal[key],
                    help_text=f"Admission WAL {key}", kind=kind)

    # replication (primary side) / live-reload config ---------------------
    repl = snapshot.get("replication") or {}
    for key, kind, help_text in (
            ("bytes_shipped", "counter", "WAL bytes shipped to the standby"),
            ("chunks_shipped", "counter", "Replication chunks shipped"),
            ("retires_shipped", "counter",
             "Segment-retire notices shipped after compaction"),
            ("ship_errors", "counter", "Failed shipping attempts"),
            ("standby_lag_entries", "gauge",
             "Entries the standby lags the primary (last ack)"),
            ("standby_lag_seconds", "gauge",
             "Seconds the standby lags the primary (last ack)"),
    ):
        if repl.get(key) is not None:
            name = (f"replication_{key}_total" if kind == "counter"
                    else f"replication_{key}")
            out.add(name, repl[key], help_text=help_text, kind=kind)
    cfg = snapshot.get("config") or {}
    if "epoch" in cfg:
        out.add("config_epoch", cfg["epoch"],
                help_text="Live-reload config epoch (0 = constructor "
                          "config; each applied reload bumps it)")

    # energy -------------------------------------------------------------
    energy = snapshot.get("energy") or {}
    if "modeled_watts" in energy:
        out.add("energy_modeled_watts", energy["modeled_watts"],
                help_text="Modeled power over the trailing window")
    if energy.get("power_cap_watts") is not None:
        out.add("energy_power_cap_watts", energy["power_cap_watts"],
                help_text="Configured dispatch power cap")
        out.add("energy_cap_saturation", energy.get("cap_saturation", 0.0),
                help_text="Modeled watts over the cap (1.0 = saturated)")
    cap = energy.get("cap") or {}
    for key, name, kind, help_text in (
            ("spent_joules", "energy_cap_spent_joules_total", "counter",
             "Joules charged through the power-cap pacer"),
            ("throttled_s_total", "energy_cap_throttle_seconds_total",
             "counter", "Dispatch seconds spent blocked on the power cap"),
            ("throttles", "energy_cap_throttles_total", "counter",
             "Batches that had to wait for the power cap"),
            ("tokens_joules", "energy_cap_tokens_joules", "gauge",
             "Joule tokens currently in the pacer bucket"),
    ):
        if key in cap:
            out.add(name, cap[key], help_text=help_text, kind=kind)
    budget = energy.get("budget") or {}
    if "rejections" in budget:
        out.add("energy_budget_rejections_total", budget["rejections"],
                help_text="Admissions bounced by a tenant joule budget",
                kind="counter")
    if "refunds" in budget:
        out.add("energy_budget_refunds_total", budget["refunds"],
                help_text="Cancel/failure refunds credited to joule budgets",
                kind="counter")
        out.add("energy_budget_refunded_joules_total",
                budget.get("refunded_joules", 0.0),
                help_text="Joules credited back by cancel/failure refunds",
                kind="counter")
    if "joules_total" in energy:
        out.add("energy_joules_total", energy["joules_total"],
                help_text="Modeled joules across all batches",
                kind="counter")
    if "joules_per_point" in energy:
        out.add("energy_joules_per_point", energy["joules_per_point"],
                help_text="Modeled joules per real (unpadded) point")
    for cls, tot in sorted((energy.get("by_class") or {}).items()):
        lab = {"device_class": cls}
        for key, name, kind in (
                ("batches", "energy_class_batches_total", "counter"),
                ("exec_s", "energy_class_exec_seconds_total", "counter"),
                ("modeled_joules", "energy_class_joules_total", "counter"),
                ("joules_per_point", "energy_class_joules_per_point",
                 "gauge"),
        ):
            if isinstance(tot, dict) and key in tot:
                out.add(name, tot[key], labels=lab,
                        help_text=f"Per-device-class {key}", kind=kind)

    # SLO ----------------------------------------------------------------
    slo = snapshot.get("slo") or {}
    if slo:
        out.add("slo_ok", 1.0 if slo.get("ok") else 0.0,
                help_text="1 when every SLO is within target over the window")
        for name in ("latency", "errors"):
            burn = slo.get(f"{name}_burn_rate")
            if burn is not None:
                out.add("slo_burn_rate", burn, labels={"slo": name},
                        help_text="Observed bad fraction / budgeted bad fraction")

    # tracer / event log health -----------------------------------------
    tr = snapshot.get("trace") or {}
    for key, kind in (("spans", "gauge"), ("emitted", "counter"),
                      ("dropped", "counter"), ("traces", "gauge")):
        if key in tr:
            out.add(f"trace_{key}", tr[key],
                    help_text=f"Span ring {key}", kind=kind)
    ev = snapshot.get("events") or {}
    for key, kind in (("written", "counter"), ("rotations", "counter"),
                      ("files", "gauge"), ("bytes", "gauge")):
        if key in ev:
            out.add(f"events_{key}", ev[key],
                    help_text=f"Event log {key}", kind=kind)
    return out.text()


def exposition_errors(text: str) -> List[str]:
    """Validate Prometheus exposition text; return a list of problems.

    Used by the CI telemetry gate (and tests) instead of a client
    library: checks line grammar, that every sample belongs to a family
    announced by a ``# TYPE`` line, and that values parse as floats.
    """
    errors: List[str] = []
    typed: set = set()
    if text and not text.endswith("\n"):
        errors.append("exposition must end with a newline")
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                errors.append(f"line {i}: malformed comment: {line!r}")
                continue
            if parts[1] == "TYPE":
                kind = parts[3] if len(parts) > 3 else ""
                if kind not in ("counter", "gauge", "histogram",
                                "summary", "untyped"):
                    errors.append(f"line {i}: unknown TYPE {kind!r}")
                typed.add(parts[2])
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: malformed sample: {line!r}")
            continue
        name = m.group(1)
        base = name
        for suffix in ("_total", "_count", "_sum", "_bucket"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
                break
        if name not in typed and base not in typed:
            errors.append(f"line {i}: sample {name!r} has no # TYPE line")
    return errors


# -- rotating JSONL event log -------------------------------------------------


class EventLog:
    """Size-rotated JSONL log of structured service events.

    Each :meth:`emit` appends one JSON object (``ts``, ``event``, ``pid``
    plus caller fields) and flushes, so the OS page cache holds the line
    even if the process is SIGKILL'd the next instant (power loss is out
    of scope, matching the WAL's fsync-on-commit boundary being the only
    stronger guarantee in the system).  Files are ``events-NNNNNNNN.jsonl``;
    a new process *continues* the latest non-full file rather than
    truncating it — required for cross-process trace merging.
    """

    def __init__(self, root: str, max_bytes: int = 4 << 20,
                 keep: int = 8) -> None:
        self.root = root
        self.max_bytes = max(4096, int(max_bytes))
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self._seq = 0
        self.written = 0
        self.rotations = 0
        self._attach()

    def _attach(self) -> None:
        """Continue the latest non-full file, or start a fresh one."""
        os.makedirs(self.root, exist_ok=True)
        existing = self._files()
        if existing:
            last = existing[-1]
            self._seq = int(last.split("-")[1].split(".")[0])
            size = os.path.getsize(os.path.join(self.root, last))
            if size < self.max_bytes:
                self._fh = open(os.path.join(self.root, last), "a")
                self._size = size
        if self._fh is None:
            self._open_next()

    def reopen(self) -> None:
        """Re-attach after :meth:`close` (service restart in-process)."""
        with self._lock:
            if self._fh is None:
                self._attach()

    def _files(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.root)
                          if n.startswith("events-") and n.endswith(".jsonl"))
        except OSError:
            return []

    def _open_next(self) -> None:
        self._seq += 1
        path = os.path.join(self.root, f"events-{self._seq:08d}.jsonl")
        self._fh = open(path, "a")
        self._size = 0
        # enforce the retention bound
        files = self._files()
        while len(files) > self.keep:
            victim = files.pop(0)
            try:
                os.unlink(os.path.join(self.root, victim))
            except OSError:
                break

    def emit(self, event: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": event, "pid": os.getpid()}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=str) + "\n"
        except (TypeError, ValueError):
            return
        with self._lock:
            if self._fh is None:
                return
            if self._size >= self.max_bytes:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self.rotations += 1
                self._open_next()
            try:
                self._fh.write(line)
                self._fh.flush()
            except (OSError, ValueError):
                return
            self._size += len(line)
            self.written += 1

    def stats(self) -> Dict[str, Any]:
        files = self._files()
        total = 0
        for name in files:
            try:
                total += os.path.getsize(os.path.join(self.root, name))
            except OSError:
                pass
        with self._lock:
            return {"files": len(files), "bytes": total,
                    "written": self.written, "rotations": self.rotations,
                    "max_bytes": self.max_bytes, "keep": self.keep}

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_events(root: str) -> Iterator[Dict[str, Any]]:
    """Yield every parseable event across the rotated files, oldest first."""
    try:
        names = sorted(n for n in os.listdir(root)
                       if n.startswith("events-") and n.endswith(".jsonl"))
    except OSError:
        return
    for name in names:
        try:
            fh = open(os.path.join(root, name), "r")
        except OSError:
            continue
        with fh:
            for line in fh:
                try:
                    yield json.loads(line)
                except ValueError:
                    continue


# -- SLO evaluation -----------------------------------------------------------


class SLOEvaluator:
    """Latency + error-rate targets with burn rates over the metrics window.

    Burn rate is the standard budget-consumption ratio: for latency, the
    fraction of windowed requests over the target divided by the allowed
    fraction (``1 - percentile/100``); for errors, observed error rate
    over the target rate.  1.0 = consuming exactly the budget.
    """

    def __init__(self, latency_target_s: float = 0.5,
                 latency_percentile: float = 99.0,
                 error_rate_target: float = 0.05) -> None:
        self.latency_target_s = float(latency_target_s)
        self.latency_percentile = float(latency_percentile)
        self.error_rate_target = float(error_rate_target)

    def evaluate(self, latencies: Sequence[float], failures: int,
                 outcomes: int) -> Dict[str, Any]:
        lat = [float(v) for v in latencies]
        p_lat = percentile(lat, self.latency_percentile) if lat else 0.0
        over = sum(1 for v in lat if v > self.latency_target_s)
        frac_over = over / len(lat) if lat else 0.0
        allowed = max(1e-9, 1.0 - self.latency_percentile / 100.0)
        latency_burn = frac_over / allowed
        error_rate = failures / outcomes if outcomes else 0.0
        error_burn = (error_rate / self.error_rate_target
                      if self.error_rate_target > 0 else 0.0)
        return {
            "latency_target_s": self.latency_target_s,
            "latency_percentile": self.latency_percentile,
            "observed_latency_s": p_lat,
            "latency_burn_rate": latency_burn,
            "error_rate_target": self.error_rate_target,
            "observed_error_rate": error_rate,
            "errors_burn_rate": error_burn,
            "window_requests": len(lat),
            "window_outcomes": outcomes,
            "ok": bool(p_lat <= self.latency_target_s
                       and error_rate <= self.error_rate_target),
        }


# -- background HTTP exporter -------------------------------------------------


class TelemetryServer:
    """Minimal scrape endpoint on a daemon thread.

    ``GET /metrics``  → Prometheus text (version 0.0.4)
    ``GET /snapshot`` → the raw ``metrics_snapshot()`` JSON
    ``GET /trace``    → Chrome trace JSON of the span ring
                        (``?id=<trace_id>`` filters to one trace)
    ``GET /healthz``  → ``ok``

    ``port=0`` binds an ephemeral port (exposed as ``.port`` after
    :meth:`start`) — used by the CI gate and tests.

    The fleet router reuses this server with two overrides:
    ``render_fn(snapshot)`` replaces :func:`render_prometheus` for
    ``/metrics`` (fleet-level series with per-worker labels), and
    ``trace_fn(trace_id)`` serves ``/trace`` when there is no local
    tracer (spans fanned out from the workers and merged).
    """

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 tracer: Optional[trace_mod.RequestTracer] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 prefix: str = "repro",
                 render_fn: Optional[Callable[[Dict[str, Any]], str]] = None,
                 trace_fn: Optional[
                     Callable[[Optional[str]], List[Dict[str, Any]]]] = None,
                 ) -> None:
        self.snapshot_fn = snapshot_fn
        self.tracer = tracer
        self.host = host
        self.port = port
        self.prefix = prefix
        self.render_fn = render_fn
        self.trace_fn = trace_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_args: Any) -> None:
                pass                      # stay quiet on the serving console

            def _send(self, code: int, body: str,
                      ctype: str = "text/plain; charset=utf-8") -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self) -> None:     # noqa: N802 (http.server API)
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        snap = outer.snapshot_fn()
                        render = outer.render_fn or (
                            lambda s: render_prometheus(s, outer.prefix))
                        self._send(
                            200, render(snap),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif url.path == "/snapshot":
                        self._send(200,
                                   json.dumps(outer.snapshot_fn(),
                                              default=str, sort_keys=True),
                                   "application/json")
                    elif url.path == "/trace":
                        tid = (parse_qs(url.query).get("id") or [None])[0]
                        if outer.tracer is not None:
                            spans = outer.tracer.export(tid)
                        elif outer.trace_fn is not None:
                            spans = outer.trace_fn(tid)
                        else:
                            self._send(404, "no tracer attached\n")
                            return
                        doc = trace_mod.chrome_trace(spans)
                        self._send(200, json.dumps(doc), "application/json")
                    elif url.path == "/healthz":
                        self._send(200, "ok\n")
                    else:
                        self._send(404, "not found\n")
                except Exception as exc:  # scrape must not kill the server
                    try:
                        self._send(500, f"error: {exc!r}\n")
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="telemetry-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *_exc: Any) -> None:
        self.stop()
