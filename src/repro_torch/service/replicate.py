"""WAL segment shipping to a warm standby, and the standby itself.

The admission WAL makes *admitted means durable* a single-machine
fact: a SIGKILL'd service replays its log.  This module stretches the
same bytes across two processes so the guarantee survives losing the
machine-equivalent (the primary's workdir): a :class:`WalShipper` tails
the primary's segments — sealed ones eagerly, the active one on a
cadence — and ships raw byte ranges over the fleet RPC framing to a
:class:`StandbyReplica`, which appends them into a mirror of the WAL
directory, CRC-validates what it applied, and tracks how far behind it
is (``lag_entries`` / ``lag_seconds``).

Three properties make the WAL format shippable as-is:

- Records are CRC-framed and independent, so the standby can apply
  *byte ranges* blindly: a chunk ending mid-frame just leaves a torn
  tail that the next chunk completes (the same torn-tail logic replay
  already has).
- Appends are strictly ordered within a segment and segments are
  numbered, so "mirror every segment to the same offsets" *is* the
  replication protocol — no sequencer beyond the file layout.
- Compaction only ever drops a fully-consumed prefix, so the standby
  retiring the same prefix can never lose a live entry.

Promotion is deliberately boring: :meth:`StandbyReplica.promote` opens a
normal :class:`~repro_torch.service.service.ClusteringService` over the
mirrored workdir and lets the existing ``recover()`` replay path do what
it always does.  The failover path and the restart path are the same
code — the only code that is ever actually tested.

The shipper pushes (primary → standby) rather than the standby pulling:
the primary knows the instant a segment grows or retires, and a dead
standby must never be able to stall admission (ship errors are counted,
never raised into the append path).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Set

from repro_torch.service import faults
from repro_torch.service.fleet import rpc
from repro_torch.service.telemetry import _Lines
from repro_torch.service.wal import _SEGMENT_RE, RequestLog

__all__ = ["WalShipper", "StandbyReplica"]


def _wal_segments(root: str) -> List[int]:
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _seg_path(root: str, seq: int) -> str:
    return os.path.join(root, f"wal-{seq:08d}.log")


class WalShipper:
    """Tails a primary's WAL directory and pushes byte ranges to a standby.

    ``wal`` is the primary's open :class:`RequestLog` — used only for
    its ``stats()`` watermark (``last_entry_id``), never for reading:
    shipping reads the segment *files*, so it sees exactly what a crash
    would leave behind, unfsynced tail included (harmless: the standby's
    CRC scan stops at any torn frame until the bytes complete).
    """

    def __init__(self, wal: RequestLog, host: str, port: int, *,
                 interval: float = 0.25, chunk_bytes: int = 1 << 20,
                 timeout: float = 10.0) -> None:
        self.wal = wal
        self.root = wal.root
        self.host = host
        self.port = port
        self.interval = float(interval)
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.timeout = float(timeout)
        self._cursor: Dict[int, int] = {}      # segment -> bytes shipped
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.bytes_shipped = 0
        self.chunks_shipped = 0
        self.ship_errors = 0
        self.retires_shipped = 0
        self.last_ship_ts: Optional[float] = None
        self.last_ack: Dict[str, Any] = {}     # standby's last reply

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "WalShipper":
        self._thread = threading.Thread(target=self._loop,
                                        name="wal-shipper", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, final_ship: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if final_ship:
            try:                       # drain whatever the loop missed
                self.ship_once()
            except Exception:
                pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.ship_once()
            except Exception:
                with self._lock:
                    self.ship_errors += 1

    # -- one shipping cycle ----------------------------------------------------

    def ship_once(self) -> Dict[str, Any]:
        """Ship every unshipped byte (and retire dropped segments) once.

        Synchronous and reentrant-safe under ``_lock``-free design: only
        one caller at a time matters (the loop, or a test / drain call
        after the loop stopped).  Returns a summary for tests.
        """
        segs = _wal_segments(self.root)
        shipped = 0
        watermark = self._watermark()
        # retire first: tell the standby which segments still exist so it
        # can drop the same fully-consumed prefix the primary compacted
        known = [s for s in self._cursor if s not in segs]
        if known:
            self._send({"op": "retire", "live_segments": segs,
                        "watermark": watermark}, b"")
            for seq in known:
                self._cursor.pop(seq, None)
            with self._lock:
                self.retires_shipped += 1
        for seq in segs:
            path = _seg_path(self.root, seq)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue                       # compacted mid-cycle
            offset = self._cursor.get(seq, 0)
            while offset < size:
                length = min(self.chunk_bytes, size - offset)
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read(length)
                if not chunk:
                    break
                header = {"op": "append", "segment": seq,
                          "offset": offset, "watermark": watermark}
                # crash window: chunk framed but not on the wire — the
                # standby simply stays behind until the next cycle
                faults.at("replicate.ship.before_send")
                if offset > 0:
                    # crash window: a partially-shipped segment — the
                    # standby holds a prefix (possibly ending mid-frame)
                    faults.at("replicate.ship.mid_segment")
                reply = self._send(header, chunk)
                if reply.get("ok"):
                    offset += len(chunk)
                    self._cursor[seq] = offset
                    with self._lock:
                        self.bytes_shipped += len(chunk)
                        self.chunks_shipped += 1
                        self.last_ship_ts = time.time()
                else:
                    # standby disagrees about where this segment ends
                    # (restart, partial apply): resync to its offset
                    offset = int(reply.get("expected_offset", 0))
                    self._cursor[seq] = offset
                shipped += 1
        return {"segments": len(segs), "chunks": shipped,
                "watermark": watermark}

    def _watermark(self) -> Dict[str, Any]:
        stats = self.wal.stats()
        return {"last_entry_id": int(stats.get("last_entry_id", 0)),
                "pending": int(stats.get("pending", 0)),
                "ts": time.time()}

    def _send(self, header: Dict[str, Any], payload: bytes) -> Dict[str, Any]:
        try:
            raw = rpc.call(self.host, self.port, "POST", "/replicate",
                           rpc.pack_frame(header, payload),
                           timeout=self.timeout)
            reply = json.loads(raw.decode() or "{}")
        except (rpc.RpcError, rpc.RemoteError, ValueError) as exc:
            with self._lock:
                self.ship_errors += 1
            raise rpc.RpcError(f"ship to {self.host}:{self.port}: "
                               f"{exc}") from None
        with self._lock:
            self.last_ack = dict(reply)
        return reply

    # -- stats -----------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            ack = dict(self.last_ack)
            return {
                "standby": f"{self.host}:{self.port}",
                "bytes_shipped": self.bytes_shipped,
                "chunks_shipped": self.chunks_shipped,
                "retires_shipped": self.retires_shipped,
                "ship_errors": self.ship_errors,
                "last_ship_ts": self.last_ship_ts,
                "standby_applied_entry_id": ack.get("applied_entry_id"),
                "standby_lag_entries": ack.get("lag_entries"),
                "standby_lag_seconds": ack.get("lag_seconds"),
            }


class StandbyReplica:
    """Warm standby: mirrors a primary's WAL and can promote into it.

    Serves four endpoints on a daemon thread:

    ``POST /replicate`` — apply a shipped chunk (or retire segments).
    ``GET /healthz``    — JSON lag report; HTTP 200 while the standby is
                          within ``max_lag_s`` of the primary, 503 when
                          it has fallen further behind (a stale standby
                          is not a safe promotion target).
    ``GET /metrics``    — ``repro_replica_*`` Prometheus series.
    ``GET /snapshot``   — the raw stats JSON.

    The mirror lives at ``<workdir>/wal`` — the same layout a live
    service uses — so :meth:`promote` is nothing but "open a service on
    this workdir and recover()".
    """

    def __init__(self, workdir: str, *, host: str = "127.0.0.1",
                 port: int = 0, max_lag_s: float = 10.0) -> None:
        self.workdir = workdir
        self.wal_root = os.path.join(workdir, "wal")
        os.makedirs(self.wal_root, exist_ok=True)
        self.host = host
        self.port = port
        self.max_lag_s = float(max_lag_s)
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # replication state
        self.applies = 0
        self.bytes_applied = 0
        self.retired_segments = 0
        self.apply_errors = 0
        self.crc_stalls = 0            # applied bytes parked behind a bad frame
        self.last_apply_ts: Optional[float] = None
        self.primary_watermark: Dict[str, Any] = {}
        self._applied_ids: Set[int] = set()
        self._consumed_ids: Set[int] = set()
        self._seg_valid_end: Dict[int, int] = {}
        self.promoted = False

    # -- HTTP server -----------------------------------------------------------

    def start(self) -> "StandbyReplica":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_args: Any) -> None:
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "application/json") -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self) -> None:   # noqa: N802 (http.server API)
                if self.path != "/replicate":
                    self._send(404, json.dumps({"error": "not found"}))
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    header, payload = rpc.unpack_frame(
                        self.rfile.read(length))
                    reply = outer._apply(header, payload)
                    self._send(200, json.dumps(reply))
                except Exception as exc:
                    with outer._lock:
                        outer.apply_errors += 1
                    status, body = rpc.encode_error(exc)
                    self._send(status, json.dumps(body))

            def do_GET(self) -> None:    # noqa: N802 (http.server API)
                try:
                    if self.path == "/healthz":
                        health = outer.health()
                        self._send(200 if health["ok"] else 503,
                                   json.dumps(health))
                    elif self.path == "/metrics":
                        self._send(200, outer.render_prometheus(),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif self.path == "/snapshot":
                        self._send(200, json.dumps(outer.stats(),
                                                   default=str,
                                                   sort_keys=True))
                    else:
                        self._send(404, json.dumps({"error": "not found"}))
                except Exception as exc:   # scrape must not kill the server
                    try:
                        self._send(500, json.dumps({"error": repr(exc)}))
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="standby-replica", daemon=True)
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

    # -- applying shipped chunks -----------------------------------------------

    def _apply(self, header: Dict[str, Any],
               payload: bytes) -> Dict[str, Any]:
        op = header.get("op")
        with self._lock:
            self.primary_watermark = dict(header.get("watermark") or {})
        if op == "retire":
            return self._retire(header)
        if op != "append":
            raise ValueError(f"unknown replicate op {op!r}")
        seq = int(header["segment"])
        offset = int(header["offset"])
        path = _seg_path(self.wal_root, seq)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if offset != size:
            # shipper and mirror disagree (standby restarted, duplicate
            # chunk after a shipper retry): tell it where we really are
            return {"ok": False, "expected_offset": size,
                    **self._lag_fields()}
        # crash window: chunk validated and positioned but not yet in the
        # mirror — the shipper just re-ships from the same offset
        faults.at("replicate.apply.before_write")
        with open(path, "ab") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            self.applies += 1
            self.bytes_applied += len(payload)
            self.last_apply_ts = time.time()
        self._rescan(seq)
        return {"ok": True, "applied_offset": size + len(payload),
                **self._lag_fields()}

    def _retire(self, header: Dict[str, Any]) -> Dict[str, Any]:
        live = set(int(s) for s in header.get("live_segments") or [])
        dropped = 0
        floor = min(live) if live else None
        for seq in _wal_segments(self.wal_root):
            # only the prefix below the primary's oldest live segment is
            # safe to drop — mirrors WAL compaction's prefix-only rule
            if floor is None or seq >= floor:
                break
            try:
                os.unlink(_seg_path(self.wal_root, seq))
            except OSError:
                break
            with self._lock:
                self._seg_valid_end.pop(seq, None)
                self.retired_segments += 1
            dropped += 1
        return {"ok": True, "retired": dropped, **self._lag_fields()}

    def _rescan(self, seq: int) -> None:
        """Re-validate one mirrored segment's CRCs and update the applied
        watermark.  ``_scan`` stops at the first torn/corrupt frame, so a
        chunk boundary mid-frame simply parks ``valid_end`` until the
        next chunk completes the record."""
        path = _seg_path(self.wal_root, seq)
        records, valid_end = RequestLog._scan(path, payloads=False)
        admits: Set[int] = set()
        consumed: Set[int] = set()
        for rec_type, rec_header, _data in records:
            if "entry_id" in rec_header:
                admits.add(int(rec_header["entry_id"]))
            for i in rec_header.get("entry_ids") or ():
                consumed.add(int(i))
        with self._lock:
            self._applied_ids |= admits
            self._consumed_ids |= consumed
            self._seg_valid_end[seq] = valid_end
            try:
                size = os.path.getsize(path)
            except OSError:
                size = valid_end
            if size > valid_end:
                self.crc_stalls += 1

    # -- watermark / health ----------------------------------------------------

    def _lag_fields(self) -> Dict[str, Any]:
        with self._lock:
            applied = max(self._applied_ids | self._consumed_ids,
                          default=0)
            primary = int(self.primary_watermark.get("last_entry_id") or 0)
            lag_entries = max(0, primary - applied)
            if lag_entries <= 0:
                lag_seconds = 0.0
            elif self.last_apply_ts is not None:
                lag_seconds = max(0.0, time.time() - self.last_apply_ts)
            else:
                lag_seconds = float("inf")
            return {"applied_entry_id": applied,
                    "lag_entries": lag_entries,
                    "lag_seconds": lag_seconds}

    def health(self) -> Dict[str, Any]:
        lag = self._lag_fields()
        ok = (not self.promoted
              and lag["lag_seconds"] <= self.max_lag_s)
        return {"ok": bool(ok), "promoted": self.promoted,
                "max_lag_s": self.max_lag_s, **lag}

    def stats(self) -> Dict[str, Any]:
        lag = self._lag_fields()
        with self._lock:
            return {
                "workdir": self.workdir,
                "segments": len(_wal_segments(self.wal_root)),
                "applies": self.applies,
                "bytes_applied": self.bytes_applied,
                "retired_segments": self.retired_segments,
                "apply_errors": self.apply_errors,
                "crc_stalls": self.crc_stalls,
                "pending_entries": len(
                    (self._applied_ids - self._consumed_ids)),
                "promoted": self.promoted,
                "primary_watermark": dict(self.primary_watermark),
                **lag,
            }

    def render_prometheus(self, prefix: str = "repro_replica") -> str:
        """The ``repro_replica_*`` exposition family."""
        snap = self.stats()
        out = _Lines(prefix)
        out.add("applied_entry_id", snap["applied_entry_id"],
                help_text="Highest WAL entry id applied on the standby")
        out.add("lag_entries", snap["lag_entries"],
                help_text="Entries the standby is behind the primary")
        out.add("lag_seconds", snap["lag_seconds"],
                help_text="Seconds since the standby last kept up")
        out.add("segments", snap["segments"],
                help_text="Mirrored WAL segments on the standby")
        out.add("pending_entries", snap["pending_entries"],
                help_text="Unconsumed entries a promotion would replay")
        out.add("applies_total", snap["applies"], kind="counter",
                help_text="Replication chunks applied")
        out.add("bytes_applied_total", snap["bytes_applied"],
                kind="counter", help_text="Replicated bytes applied")
        out.add("retired_segments_total", snap["retired_segments"],
                kind="counter",
                help_text="Mirrored segments retired after compaction")
        out.add("apply_errors_total", snap["apply_errors"], kind="counter",
                help_text="Replication apply failures")
        out.add("crc_stalls_total", snap["crc_stalls"], kind="counter",
                help_text="Applies parked behind an incomplete frame")
        out.add("ok", 1.0 if self.health()["ok"] else 0.0,
                help_text="1 while the standby is a safe promotion target")
        return out.text()

    # -- promotion -------------------------------------------------------------

    def promote(self, *, replay_rate: Optional[float] = None,
                replay_burst: int = 8, device: str = "cuda",
                **service_kwargs: Any):
        """Stop replicating and become the primary.

        Opens a live :class:`ClusteringService` over the mirrored
        workdir on ``device`` (the card unless the caller asks for the
        CPU; without a card the service's constructor raises) and
        replays the unconsumed WAL tail through the normal ``recover()``
        path (rate-shapeable, content-hash deduped).  The replayed
        requests keep the lanes they were admitted on (``cuda-kernel`` /
        ``torch-ref`` / ``numpy-mt``).  Returns ``(service,
        recovery_summary)``; the caller owns the service's lifecycle.
        """
        from repro_torch.service.service import ClusteringService

        self.stop()                    # no more applies: the mirror is final
        with self._lock:
            self.promoted = True
        service_kwargs.setdefault("wal", True)
        service = ClusteringService(self.workdir, device=device,
                                    **service_kwargs)
        service.start()
        try:
            summary = service.recover(replay_rate=replay_rate,
                                      replay_burst=replay_burst)
        except Exception:
            service.stop(timeout=10.0)
            raise
        return service, summary
