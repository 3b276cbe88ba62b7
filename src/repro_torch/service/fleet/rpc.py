"""Fleet-local RPC: framed numpy-over-HTTP between router and workers.

Same dependency stance as :mod:`repro_torch.service.telemetry`: stdlib
and numpy only — ``http.client`` on the caller side, the workers serve
with ``ThreadingHTTPServer``.  Results are numpy arrays by the time they
leave the executor, so nothing here touches torch.  Payloads are framed
as::

    u32 header_len | JSON header | raw payload bytes

with arrays carried as ``.npy``/``.npz`` (the WAL's own wire format), so
a request's bytes are identical on the wire, in the admission log, and
in the spill cache.

Errors cross the wire structurally: a worker maps a typed admission
exception to ``(HTTP status, JSON body)`` via :func:`encode_error`, and
:func:`raise_mapped` rebuilds the *same* exception type on the caller —
the router's retry/backoff logic handles a remote ``BacklogFull``
exactly like a local one, honouring its ``retry_after``.
"""

from __future__ import annotations

import http.client
import io
import json
import socket
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.service.queue import (BacklogFull, EnergyBudgetExceeded,
                                       RateLimited, RequestDropped,
                                       RequestTooLarge)
from repro_torch.service.wal import WalLocked

_LEN = struct.Struct("<I")
_MAX_HEADER = 1 << 20


class RpcError(RuntimeError):
    """Transport-level failure (connect refused, reset, timeout, bad
    frame) — the worker may be dead; the router treats this as a signal
    to mark it suspect and try elsewhere."""


class RemoteError(RuntimeError):
    """The worker answered with an error the caller has no typed mapping
    for (a bug surfaced remotely, not admission pressure)."""

    def __init__(self, message: str, *, kind: str = "RemoteError") -> None:
        super().__init__(message)
        self.kind = kind


# -- framing ------------------------------------------------------------------


def pack_frame(header: Dict[str, Any], payload: bytes = b"") -> bytes:
    hdr = json.dumps(header).encode()
    return _LEN.pack(len(hdr)) + hdr + payload


def unpack_frame(data: bytes) -> Tuple[Dict[str, Any], bytes]:
    if len(data) < _LEN.size:
        raise RpcError("frame shorter than its length prefix")
    (hlen,) = _LEN.unpack_from(data)
    if hlen > _MAX_HEADER or _LEN.size + hlen > len(data):
        raise RpcError("frame header length out of bounds")
    try:
        header = json.loads(data[_LEN.size:_LEN.size + hlen].decode())
    except ValueError as exc:
        raise RpcError(f"undecodable frame header: {exc}") from None
    return header, data[_LEN.size + hlen:]


def encode_array(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def decode_array(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw), allow_pickle=False)


def encode_result(result: Dict[str, Any]) -> bytes:
    """One result dict → frame: scalars ride the JSON header, arrays an
    ``.npz`` payload (empty payload when the result is scalar-only)."""
    arrays = {k: v for k, v in result.items() if isinstance(v, np.ndarray)}
    scalars = {k: v for k, v in result.items()
               if not isinstance(v, np.ndarray)}
    payload = b""
    if arrays:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
    return pack_frame({"scalars": scalars, "arrays": sorted(arrays)},
                      payload)


def decode_result(data: bytes) -> Dict[str, Any]:
    header, payload = unpack_frame(data)
    result: Dict[str, Any] = dict(header.get("scalars") or {})
    if header.get("arrays"):
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            for name in z.files:
                result[name] = z[name]
    return result


# -- typed errors over the wire ----------------------------------------------


def encode_error(exc: BaseException) -> Tuple[int, Dict[str, Any]]:
    """Exception → (HTTP status, JSON body) for the worker's error path."""
    body: Dict[str, Any] = {"error": type(exc).__name__, "message": str(exc)}
    if isinstance(exc, BacklogFull):
        body.update(tenant=exc.tenant, depth=exc.depth, limit=exc.limit,
                    retry_after=exc.retry_after)
        return 429, body
    if isinstance(exc, RateLimited):
        body.update(tenant=exc.tenant, retry_after=exc.retry_after,
                    rate=exc.rate, burst=exc.burst)
        return 429, body
    if isinstance(exc, EnergyBudgetExceeded):
        body.update(tenant=exc.tenant, retry_after=exc.retry_after,
                    needed_joules=exc.needed_joules,
                    rate=exc.rate, burst=exc.burst)
        return 429, body
    if isinstance(exc, WalLocked):
        body.update(root=exc.root, holder_pid=exc.holder_pid,
                    retry_after=exc.retry_after)
        return 503, body
    if isinstance(exc, RequestTooLarge):
        body.update(tenant=exc.tenant, n_points=exc.n_points)
        return 413, body
    if isinstance(exc, RequestDropped):
        body.update(resubmit=exc.resubmit)
        return 409, body
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return 400, body
    return 500, body


def raise_mapped(status: int, body: Dict[str, Any]) -> None:
    """(status, JSON body) → the original typed exception, re-raised."""
    kind = str(body.get("error") or "RemoteError")
    message = str(body.get("message") or f"worker returned HTTP {status}")
    if kind == "BacklogFull":
        raise BacklogFull(message, tenant=body.get("tenant"),
                          depth=int(body.get("depth") or 0),
                          limit=int(body.get("limit") or 0),
                          retry_after=float(body.get("retry_after") or 0.1))
    if kind == "RateLimited":
        raise RateLimited(message, tenant=str(body.get("tenant")),
                          retry_after=float(body.get("retry_after") or 0.1),
                          rate=float(body.get("rate") or 0.0),
                          burst=int(body.get("burst") or 0))
    if kind == "EnergyBudgetExceeded":
        raise EnergyBudgetExceeded(
            message, tenant=str(body.get("tenant")),
            retry_after=float(body.get("retry_after") or 0.1),
            needed_joules=float(body.get("needed_joules") or 0.0),
            rate=float(body.get("rate") or 0.0),
            burst=float(body.get("burst") or 0.0))
    if kind == "WalLocked":
        raise WalLocked(message, root=str(body.get("root") or ""),
                        holder_pid=body.get("holder_pid"),
                        retry_after=float(body.get("retry_after") or 0.5))
    if kind == "RequestTooLarge":
        raise RequestTooLarge(message, tenant=str(body.get("tenant")),
                              n_points=int(body.get("n_points") or 0))
    if kind == "RequestDropped":
        raise RequestDropped(message,
                             resubmit=bool(body.get("resubmit")))
    raise RemoteError(message, kind=kind)


# -- caller side --------------------------------------------------------------


def call(host: str, port: int, method: str, path: str,
         body: Optional[bytes] = None, *,
         timeout: float = 30.0,
         content_type: str = "application/octet-stream") -> bytes:
    """One HTTP round trip; returns the raw response body.

    2xx → body.  Any mapped error status raises the typed exception from
    the JSON body; transport failures raise :class:`RpcError`.
    """
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        headers = {"Content-Type": content_type} if body is not None else {}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        if 200 <= resp.status < 300:
            return data
        try:
            payload = json.loads(data.decode() or "{}")
        except ValueError:
            payload = {"error": "RemoteError",
                       "message": data.decode(errors="replace")[:200]}
        raise_mapped(resp.status, payload)
        raise AssertionError("raise_mapped returned")  # pragma: no cover
    except (OSError, socket.timeout, http.client.HTTPException) as exc:
        raise RpcError(f"{method} {host}:{port}{path}: {exc!r}") from exc
    finally:
        conn.close()


def get_json(host: str, port: int, path: str, *,
             timeout: float = 10.0) -> Dict[str, Any]:
    data = call(host, port, "GET", path, timeout=timeout)
    try:
        return json.loads(data.decode())
    except ValueError as exc:
        raise RpcError(f"non-JSON response from {path}: {exc}") from None


def post_json(host: str, port: int, path: str, obj: Dict[str, Any], *,
              timeout: float = 30.0) -> Dict[str, Any]:
    data = call(host, port, "POST", path, json.dumps(obj).encode(),
                timeout=timeout, content_type="application/json")
    try:
        return json.loads(data.decode())
    except ValueError as exc:
        raise RpcError(f"non-JSON response from {path}: {exc}") from None
