"""Fleet worker: one `ClusteringService` behind a local RPC door.

Each worker is its own OS process over its own workdir — its own WAL
(single-writer lock), result cache, checkpoint store, and event log —
so a SIGKILL takes out exactly one worker's in-memory state and nothing
else.  :class:`FleetWorker` wraps a started service with a
``ThreadingHTTPServer`` speaking the :mod:`repro_torch.service.fleet.rpc`
framing:

``POST /submit``    framed request → result (``wait=true``, the default)
                    or a JSON admission ACK (``wait=false`` — the request
                    is durable in this worker's WAL; fetch the result
                    later by content hash)
``GET  /result``    ``?key=<cache_key>[&timeout=s]`` → framed result once
                    the content hash resolves (serves replayed work after
                    a takeover: the key is stable across processes)
``GET  /healthz``   heartbeat JSON: queue depth, WAL pending, SLO burn,
                    energy EWMA, draining flag
``GET  /snapshot``  full ``metrics_snapshot()`` JSON
``GET  /metrics``   this worker's own Prometheus exposition
``GET  /spans``     raw span dicts (``?id=`` filters one trace) — the
                    router merges these across workers
``POST /takeover``  ``{"wal_root": ...}`` → adopt a dead peer's WAL via
                    :meth:`ClusteringService.replay_foreign`
``POST /stream``    streaming-session ops (open/push/flush/snapshot/
                    assign/close) for sticky-routed tenants

Run as a process: ``python -m repro_torch.service.fleet.worker --workdir D
--announce F --name W0 [--config JSON]``.  The worker binds an ephemeral
port and *announces* it by writing ``{name, pid, host, port, workdir}``
atomically to the announce file — the manager's spawn handshake.

The service runs on the CUDA card unless ``--config`` says ``"device":
"cpu"``; without a card the service's constructor raises and the worker
exits non-zero before it announces.  On the card every kernel library is
loaded (or built, if the parent has not built it) before the announce,
so no request pays a build the manager did not wait for, and a failed
build ends the process the same way.  Each worker holds its own CUDA
context on the one card.
SIGTERM triggers a graceful drain-stop (finish in-flight, consume WAL
entries, release the lock); SIGKILL is the failover path the rest of the
fleet is built to survive.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.kernels import _build
from repro_torch.kernels.distance import fused, ops as dops
from repro_torch.kernels.neighbor import ops as nops
from repro_torch.service.fleet import rpc
from repro_torch.service.service import ClusteringService
from repro_torch.service.session import StreamingSession
from repro_torch.service.telemetry import render_prometheus


class FleetWorker:
    """RPC door over one started :class:`ClusteringService`."""

    def __init__(self, service: ClusteringService, *, name: str,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.service = service
        self.name = name
        self.host = host
        self.port = port
        self.started_at = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._streams: Dict[str, StreamingSession] = {}
        self._streams_lock = threading.Lock()

    # -- request handling ----------------------------------------------------

    def _handle_submit(self, body: bytes) -> tuple:
        header, payload = rpc.unpack_frame(body)
        data = rpc.decode_array(payload)
        req = self.service._submit(
            str(header["tenant"]), str(header["algo"]), data,
            params=dict(header.get("params") or {}),
            executor=header.get("executor"),
            priority=int(header.get("priority", 1)),
            deadline=header.get("deadline"),
            ttl=header.get("ttl"))
        if not header.get("wait", True):
            # admission ACK: the request is durable in this worker's WAL;
            # the caller owns the content hash and fetches the result from
            # whoever ends up computing it (this worker, or — after a
            # SIGKILL — the survivor that adopts this WAL)
            return ("json", {"accepted": True,
                             "request_id": req.request_id,
                             "cache_key": req.cache_key,
                             "trace_id": req.trace_id,
                             "cache_hit": bool(req.cache_hit),
                             "worker": self.name})
        result = req.wait(float(header.get("timeout") or 300.0))
        meta = {"__request_id": req.request_id,
                "__cache_hit": bool(req.cache_hit),
                "__cache_key": req.cache_key,
                "__trace_id": req.trace_id,
                "__worker": self.name}
        return ("frame", rpc.encode_result({**result, **meta}))

    def _handle_result(self, key: str, timeout: float) -> tuple:
        """Resolve a content hash: cache first, then any in-flight request
        carrying the same key, polling until the deadline.  A replayed
        entry lands in one of those two places the moment the takeover
        resubmits it — before that the key is simply unknown here and the
        caller backs off and retries."""
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            cached = self.service.cache.get(key)
            if cached is not None:
                return ("frame", rpc.encode_result(
                    {**cached, "__cache_key": key, "__worker": self.name}))
            with self.service._lock:
                req = next((r for r in self.service._inflight.values()
                            if r.cache_key == key), None)
            if req is not None:
                result = req.wait(max(0.1, deadline - time.monotonic()))
                return ("frame", rpc.encode_result(
                    {**result, "__cache_key": key, "__worker": self.name}))
            if time.monotonic() >= deadline:
                return ("error", 404, {
                    "error": "NotFound",
                    "message": f"content hash {key[:12]}… not known to "
                               f"worker {self.name} (yet)"})
            time.sleep(0.05)

    def health(self) -> Dict[str, Any]:
        """The heartbeat payload: cheap gauges the manager and router use
        for liveness, placement load, and failover decisions."""
        svc = self.service
        snap = svc.metrics_snapshot()
        slo = snap.get("slo") or {}
        return {
            "name": self.name,
            "pid": os.getpid(),
            "uptime_s": time.time() - self.started_at,
            "queue_depth": len(svc.queue),
            "inflight": len(svc._inflight),
            "draining": bool(svc._draining),
            "wal_pending": (svc.wal.pending() if svc.wal is not None else 0),
            "requests_total": (snap.get("totals") or {}).get("requests", 0),
            "slo_latency_burn": slo.get("latency_burn_rate", 0.0),
            "slo_errors_burn": slo.get("errors_burn_rate", 0.0),
            "modeled_joules": (snap.get("totals") or {}).get(
                "modeled_joules", 0.0),
            # power surface: the router routes around cap-saturated
            # workers and the fleet scrape exports per-worker watts
            "modeled_watts": (snap.get("energy") or {}).get(
                "modeled_watts", 0.0),
            "power_cap_watts": (snap.get("energy") or {}).get(
                "power_cap_watts"),
            "cap_saturation": (snap.get("energy") or {}).get(
                "cap_saturation", 0.0),
            # live-reload proof: a fleet-wide reload is verified by
            # watching every worker's epoch converge on the new value
            "config_epoch": svc.config_epoch,
        }

    def _handle_reload(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Apply a live config reload; validation errors map to HTTP 400
        via the normal typed-error path (ValueError)."""
        changes = dict(body.get("changes") or {})
        cfg = self.service.apply_config(changes)
        return {"worker": self.name, "epoch": cfg.epoch,
                "config": cfg.as_dict()}

    def _handle_takeover(self, body: Dict[str, Any]) -> Dict[str, Any]:
        summary = self.service.replay_foreign(
            str(body["wal_root"]),
            replay_rate=body.get("replay_rate"),
            replay_burst=int(body.get("replay_burst", 8)))
        return {
            "worker": self.name,
            "wal_root": summary["wal_root"],
            "replayed": summary["replayed"],
            "cache_hits": summary["cache_hits"],
            "rejected": summary["rejected"],
            "pending_after": summary["pending_after"],
            "cache_keys": [r.cache_key for r in summary["requests"]],
        }

    # -- streaming sessions --------------------------------------------------

    def _stream(self, tenant: str, name: str) -> Optional[StreamingSession]:
        with self._streams_lock:
            return self._streams.get(f"{tenant}/{name}")

    def _handle_stream(self, body: bytes) -> tuple:
        header, payload = rpc.unpack_frame(body)
        op = str(header.get("op"))
        tenant, name = str(header["tenant"]), str(header.get("name",
                                                            "default"))
        key = f"{tenant}/{name}"
        # every stream success is a FRAME (even scalar-only ones): the
        # router must never have to sniff whether a 200 body is JSON
        if op == "open":
            root = os.path.join(self.service.workdir, "streams")
            # the session runs where the service runs unless the caller
            # names a device
            kwargs = {"device": self.service.device,
                      **dict(header.get("kwargs") or {})}
            with self._streams_lock:
                if key not in self._streams:
                    self._streams[key] = StreamingSession(
                        root, tenant, name, **kwargs)
            return ("frame", rpc.encode_result(
                {"opened": True, "worker": self.name}))
        sess = self._stream(tenant, name)
        if sess is None:
            return ("error", 404, {"error": "NotFound",
                                   "message": f"no open stream {key}"})
        if op == "push":
            return ("frame", rpc.encode_result(
                {"applied": sess.push(rpc.decode_array(payload)),
                 "worker": self.name}))
        if op == "flush":
            return ("frame", rpc.encode_result(
                {"applied": sess.flush(), "worker": self.name}))
        if op == "snapshot":
            # centroids ride as an array when initialised, a JSON null
            # before that — encode_result splits them either way
            return ("frame", rpc.encode_result(dict(sess.snapshot())))
        if op == "assign":
            labels = sess.assign(rpc.decode_array(payload))
            return ("frame", rpc.encode_result({"labels": labels}))
        if op == "close":
            with self._streams_lock:
                self._streams.pop(key, None)
            sess.close()
            return ("frame", rpc.encode_result(
                {"closed": True, "worker": self.name}))
        return ("error", 400, {"error": "ValueError",
                               "message": f"unknown stream op {op!r}"})

    # -- the HTTP server -----------------------------------------------------

    def start(self) -> "FleetWorker":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_args: Any) -> None:
                pass

            def _send(self, code: int, data: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_json(self, code: int, obj: Dict[str, Any]) -> None:
                self._send(code, json.dumps(obj, default=str).encode())

            def _reply(self, out: tuple) -> None:
                if out[0] == "frame":
                    self._send(200, out[1], "application/octet-stream")
                elif out[0] == "json":
                    self._send_json(200, out[1])
                else:                      # ("error", status, body)
                    self._send_json(out[1], out[2])

            def _body(self) -> bytes:
                length = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(length) if length else b""

            def do_POST(self) -> None:    # noqa: N802 (http.server API)
                url = urlparse(self.path)
                try:
                    if url.path == "/submit":
                        self._reply(outer._handle_submit(self._body()))
                    elif url.path == "/takeover":
                        body = json.loads(self._body().decode() or "{}")
                        self._send_json(200, outer._handle_takeover(body))
                    elif url.path == "/reload":
                        body = json.loads(self._body().decode() or "{}")
                        self._send_json(200, outer._handle_reload(body))
                    elif url.path == "/stream":
                        self._reply(outer._handle_stream(self._body()))
                    else:
                        self._send_json(404, {"error": "NotFound",
                                              "message": self.path})
                except Exception as exc:
                    status, body = rpc.encode_error(exc)
                    try:
                        self._send_json(status, body)
                    except OSError:
                        pass

            def do_GET(self) -> None:     # noqa: N802 (http.server API)
                url = urlparse(self.path)
                q = parse_qs(url.query)
                try:
                    if url.path == "/healthz":
                        self._send_json(200, outer.health())
                    elif url.path == "/result":
                        key = (q.get("key") or [""])[0]
                        timeout = float((q.get("timeout") or ["30"])[0])
                        self._reply(outer._handle_result(key, timeout))
                    elif url.path == "/snapshot":
                        self._send_json(200, {
                            **outer.service.metrics_snapshot(),
                            "kernel_launches": kernel_launches()})
                    elif url.path == "/metrics":
                        text = render_prometheus(
                            outer.service.metrics_snapshot())
                        self._send(200, text.encode(),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif url.path == "/spans":
                        tid = (q.get("id") or [None])[0]
                        self._send(200, json.dumps(
                            outer.service.export_trace(tid),
                            default=str).encode())
                    else:
                        self._send_json(404, {"error": "NotFound",
                                              "message": self.path})
                except Exception as exc:
                    status, body = rpc.encode_error(exc)
                    try:
                        self._send_json(status, body)
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"fleet-worker-{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._streams_lock:
            streams, self._streams = dict(self._streams), {}
        for sess in streams.values():
            try:
                sess.close()
            except Exception:
                pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def kernel_launches() -> Dict[str, int]:
    """This process's launches of each mining kernel, by the wrappers' own
    counters (runs of the plain versions on CPU tensors do not count)."""
    return {"assign_clusters": dops.assign_clusters.launches,
            "fused_masked_assign_update":
                fused.fused_masked_assign_update.launches,
            "epsilon_degree": nops.epsilon_degree.launches,
            "expand_frontier": nops.expand_frontier.launches}


# -- process entry point ------------------------------------------------------


def _write_announce(path: str, payload: Dict[str, Any]) -> None:
    """Atomic announce: the manager must never read a half-written file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.service.fleet.worker",
        description="One fleet worker process (spawned by WorkerManager).")
    p.add_argument("--workdir", required=True,
                   help="this worker's private state root")
    p.add_argument("--announce", required=True,
                   help="file to write {name, pid, host, port} to once "
                        "the RPC door is bound")
    p.add_argument("--name", default="worker", help="worker name (labels)")
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    p.add_argument("--port", type=int, default=0,
                   help="bind port (0 = ephemeral)")
    p.add_argument("--config", default="{}",
                   help="JSON object of ClusteringService kwargs (the "
                        "device is \"cuda\" unless it says \"cpu\")")
    p.add_argument("--standby", default=None, metavar="HOST:PORT",
                   help="ship WAL segments to a warm standby replica at "
                        "this address")
    p.add_argument("--replay-rate", type=float, default=None,
                   help="rate-shape startup WAL replay (requests/s)")
    return p


def main(argv: Optional[list] = None) -> int:
    # wall-clock marks of the start-up, announced so the manager can split
    # its spawn time: the interpreter and imports end here
    marks = {"imports": time.time()}
    args = build_parser().parse_args(argv)
    cfg = json.loads(args.config)
    service = ClusteringService(args.workdir, **cfg)
    marks["service"] = time.time()
    if service.device == "cuda":
        _build.build_all()
    marks["kernels"] = time.time()
    service.start()
    # A rolling-restart successor inherits its predecessor's workdir; any
    # unconsumed WAL tail (admitted but never batched) replays here.  On a
    # fresh workdir this is a no-op.
    service.recover(replay_rate=args.replay_rate)
    shipper = None
    if args.standby and service.wal is not None:
        from repro_torch.service.replicate import WalShipper
        s_host, _, s_port = args.standby.rpartition(":")
        shipper = WalShipper(service.wal, s_host or "127.0.0.1",
                             int(s_port)).start()
        service.attach_replicator(shipper)
    worker = FleetWorker(service, name=args.name,
                         host=args.host, port=args.port).start()
    marks["start"] = time.time()
    _write_announce(args.announce, {
        "name": args.name, "pid": os.getpid(),
        "host": args.host, "port": worker.port, "workdir": args.workdir,
        "marks": marks})

    stop_evt = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop_evt.set())
    stop_evt.wait()
    # SIGTERM = rolling restart: drain (finish in-flight, consume their
    # WAL entries, release the lock) so a successor starts clean.  The
    # SIGKILL path never gets here — that's what failover is for.
    worker.stop()
    service.stop(drain=True)
    if shipper is not None:
        shipper.stop(final_ship=True)
    return 0


if __name__ == "__main__":               # pragma: no cover - subprocess entry
    sys.exit(main())
