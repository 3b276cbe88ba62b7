"""FleetRouter: the MiningClient-shaped front door over N workers.

Placement is :class:`~repro_torch.service.fleet.hashring.ConsistentHashRing`
with bounded load — a tenant lands on its ring primary until that worker
saturates, then spills clockwise — except for *sticky* tenants: opening
a streaming session pins its tenant to one worker (the session's model
state lives in that worker's workdir), and every later submit follows
the pin while the worker lives.

Retry/backoff is structural, mirroring the single-process client's
contract: a remote ``BacklogFull``/``RateLimited``/``WalLocked`` arrives
as the *same typed exception* (see :mod:`repro_torch.service.fleet.rpc`) and
the router sleeps its ``retry_after`` before re-placing — bounded-load
means the retry usually lands on a different worker.  A transport error
(connection refused/reset: the worker may be mid-death) marks the worker
*suspect* for a cooldown so placement routes around it until the
heartbeat loop decides; the request itself is retried elsewhere
immediately.  Retried submits are at-least-once — safe because workers
dedupe by content hash, the same property WAL replay already leans on.

Two submit shapes:

- ``submit(...)`` (default) — the worker holds the request until the
  result is ready; one RPC, MiningClient semantics.
- ``submit(..., durable=True)`` — the RPC returns at *admission* (the
  request is fsynced in the worker's WAL); ``handle.result()`` later
  fetches by content hash from whichever worker ends up owning the work.
  If the admitting worker is SIGKILLed first, the manager's failover
  replays its WAL on a survivor and the router follows the adopter chain
  to fetch from there — zero admitted requests lost.

Fleet observability: ``metrics_snapshot()`` fans ``/snapshot`` out
across workers and merges with manager + router state;
:func:`render_fleet_prometheus` renders it as ``repro_fleet_*`` series
with a ``worker`` label; ``trace()`` fans ``/spans`` out and merges one
trace across every process that touched it.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.service.fleet import rpc
from repro_torch.service.fleet.hashring import ConsistentHashRing
from repro_torch.service.fleet.manager import WorkerManager, WorkerSpec
from repro_torch.service.queue import (PRIORITY_NORMAL, BacklogFull,
                                       EnergyBudgetExceeded, RateLimited)
from repro_torch.service.telemetry import TelemetryServer, _Lines
from repro_torch.service.wal import WalLocked

_META_KEYS = ("__request_id", "__cache_hit", "__cache_key", "__trace_id",
              "__worker")


class FleetHandle:
    """Future over one fleet request (ResultHandle-shaped).

    ``durable=False``: resolves to the finished result.  ``durable=True``:
    resolves at admission (``admitted()`` returns the ACK); ``result()``
    then fetches by content hash, surviving worker death in between.
    """

    def __init__(self, router: "FleetRouter", tenant: str,
                 future: "Future", durable: bool) -> None:
        self._router = router
        self._future = future
        self._durable = durable
        self.tenant = tenant
        self._meta: Dict[str, Any] = {}

    def admitted(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until the request is accepted somewhere.  For durable
        submits this is the WAL-fsynced admission ACK; for waiting
        submits it only resolves with the result itself."""
        out = self._future.result(timeout)
        if self._durable:
            self._meta = {f"__{k}": v for k, v in out.items()}
        return out

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if self._durable:
            ack = self.admitted(timeout)
            result = self._router._fetch_result(
                str(ack["worker"]), str(ack["cache_key"]), timeout=timeout)
        else:
            result = self._future.result(timeout)
        self._meta.update({k: result[k] for k in _META_KEYS if k in result})
        return {k: v for k, v in result.items() if k not in _META_KEYS}

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout)

    def done(self) -> bool:
        return self._future.done()

    def cancel(self) -> bool:
        return self._future.cancel()

    @property
    def cache_hit(self) -> bool:
        return bool(self._meta.get("__cache_hit"))

    @property
    def cache_key(self) -> Optional[str]:
        return self._meta.get("__cache_key")

    @property
    def trace_id(self) -> Optional[str]:
        return self._meta.get("__trace_id")

    @property
    def request_id(self) -> Optional[int]:
        return self._meta.get("__request_id")

    @property
    def worker(self) -> Optional[str]:
        """Worker that answered (may differ from the admitting worker
        after a failover)."""
        return self._meta.get("__worker")

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"FleetHandle(tenant={self.tenant!r}, {state})"


class FleetStream:
    """Sticky streaming-session proxy: every op follows the tenant's pin.

    If the pinned worker dies, the pin moves to the WAL adopter and the
    session re-opens there from scratch — streaming model state is
    worker-local (its checkpoints live in the dead workdir), so the model
    restarts empty on the survivor.  Documented fleet limitation; the
    admission-WAL guarantee covers batch requests, not stream folds.
    """

    def __init__(self, router: "FleetRouter", tenant: str, name: str,
                 kwargs: Dict[str, Any]) -> None:
        self._router = router
        self.tenant = tenant
        self.name = name
        self._kwargs = dict(kwargs)

    def _op(self, op: str, payload: bytes = b"",
            **fields: Any) -> Dict[str, Any]:
        return self._router._stream_op(
            self.tenant, self.name, op, payload,
            open_kwargs=self._kwargs, **fields)

    def push(self, points: np.ndarray) -> int:
        return int(self._op("push", rpc.encode_array(
            np.asarray(points)))["applied"])

    def flush(self) -> int:
        return int(self._op("flush")["applied"])

    def snapshot(self) -> Dict[str, Any]:
        return self._op("snapshot")

    def assign(self, points: np.ndarray) -> np.ndarray:
        return self._op("assign",
                        rpc.encode_array(np.asarray(points)))["labels"]

    def close(self) -> None:
        self._op("close")
        self._router._unpin(self.tenant)

    def __enter__(self) -> "FleetStream":
        return self

    def __exit__(self, *_exc: Any) -> None:
        self.close()


# Heartbeat cap_saturation above this marks a worker as power-throttled:
# placement treats it as heavily loaded and spills traffic elsewhere.
CAP_SATURATION_AVOID = 0.95


class FleetRouter:
    """Consistent-hash front door over a :class:`WorkerManager`'s fleet."""

    def __init__(self, manager: WorkerManager, *,
                 replicas: int = 64, load_factor: float = 1.25,
                 max_attempts: int = 8, backoff_cap: float = 1.0,
                 suspect_cooldown: float = 2.0,
                 request_timeout: float = 300.0,
                 pool_size: int = 16) -> None:
        self.manager = manager
        self.max_attempts = int(max_attempts)
        self.backoff_cap = float(backoff_cap)
        self.suspect_cooldown = float(suspect_cooldown)
        self.request_timeout = float(request_timeout)
        self._lock = threading.Lock()
        self.ring = ConsistentHashRing(
            [w.name for w in manager.live_workers()],
            replicas=replicas, load_factor=load_factor)
        self._outstanding: Dict[str, int] = {}
        self._suspect_until: Dict[str, float] = {}
        self._sticky: Dict[str, str] = {}          # tenant -> worker name
        self.counters = {"submitted": 0, "completed": 0, "retries": 0,
                         "spills": 0, "rejected": 0, "reroutes": 0,
                         "result_fetches": 0, "restart_drains": 0,
                         "restart_restores": 0, "reloads": 0}
        self._pool = ThreadPoolExecutor(
            max_workers=pool_size, thread_name_prefix="fleet-router")
        manager.on_death(self._on_death)
        # rolling-restart lifecycle (older/stub managers may not have it)
        on_restart = getattr(manager, "on_restart", None)
        if on_restart is not None:
            on_restart(self._on_restart)

    # -- membership ----------------------------------------------------------

    def _on_death(self, victim: str, adopter: Optional[str]) -> None:
        with self._lock:
            self.ring.remove(victim)
            self._suspect_until.pop(victim, None)
            moved = [t for t, w in self._sticky.items() if w == victim]
            for tenant in moved:
                # the WAL adopter is the natural new home: it is about to
                # replay the victim's admits, so the tenant's cached work
                # lands there too
                if adopter is not None:
                    self._sticky[tenant] = adopter
                else:
                    del self._sticky[tenant]
            self.counters["reroutes"] += len(moved)

    def _on_restart(self, name: str, phase: str) -> None:
        """Rolling restart: drop the draining worker from the ring so new
        placements flow to its peers, then re-add the successor.  Sticky
        pins are left in place — the successor owns the same workdir, so
        the pin resumes the moment the worker is restored (while drained,
        ``place()`` falls through to ring placement over the peers)."""
        with self._lock:
            if phase == "drain":
                self.ring.remove(name)
                self._suspect_until.pop(name, None)
                self.counters["restart_drains"] += 1
            elif phase == "restored":
                if name not in self.ring:
                    self.ring.add(name)
                self.counters["restart_restores"] += 1

    def _mark_suspect(self, name: str) -> None:
        with self._lock:
            self._suspect_until[name] = (time.monotonic()
                                         + self.suspect_cooldown)

    def _unpin(self, tenant: str) -> None:
        with self._lock:
            self._sticky.pop(tenant, None)

    # -- placement -----------------------------------------------------------

    def place(self, tenant: str) -> str:
        """Pick the worker for one request of this tenant, now: sticky pin
        first, then bounded-load consistent hashing over live workers
        (suspect workers count as saturated so traffic flows around
        them)."""
        with self._lock:
            pin = self._sticky.get(tenant)
            if pin is not None and pin in self.ring:
                return pin
            now = time.monotonic()

            def load(name: str) -> int:
                if self._suspect_until.get(name, 0.0) > now:
                    return 1 << 30
                # a cap-saturated worker (heartbeat says modeled watts are
                # pinned at its --power-cap) is throttling dispatch: heavy
                # penalty, but below suspect so it still beats a dead one
                try:
                    health = self.manager.worker(name).health or {}
                except KeyError:
                    health = {}
                penalty = 0
                if float(health.get("cap_saturation") or 0.0) > \
                        CAP_SATURATION_AVOID:
                    penalty = 1 << 20
                return self._outstanding.get(name, 0) + penalty

            total = sum(self._outstanding.get(n, 0)
                        for n in self.ring.nodes)
            chosen = self.ring.place(tenant, load, total_load=total)
            if chosen is None:
                raise RuntimeError("fleet has no live workers")
            if chosen != self.ring.primary(tenant):
                self.counters["spills"] += 1
            return chosen

    def _spec(self, name: str) -> WorkerSpec:
        return self.manager.worker(name)

    # -- submit --------------------------------------------------------------

    def submit(self, tenant: str, algo: str, data: np.ndarray, *,
               params: Dict[str, Any], executor: Optional[str] = None,
               priority: int = PRIORITY_NORMAL,
               deadline: Optional[float] = None,
               ttl: Optional[float] = None,
               durable: bool = False,
               timeout: Optional[float] = None) -> FleetHandle:
        """MiningClient-compatible async submit; returns immediately.

        The returned handle's ``result()`` blocks for the labels.
        ``durable=True`` switches to admission-ACK mode (see the class
        docstring) — the mode the fleet durability gate runs in.
        """
        header = {"tenant": tenant, "algo": algo,
                  "params": dict(params), "executor": executor,
                  "priority": int(priority), "deadline": deadline,
                  "ttl": ttl, "wait": not durable,
                  "timeout": timeout or self.request_timeout}
        payload = rpc.pack_frame(header,
                                 rpc.encode_array(np.asarray(data)))
        with self._lock:
            self.counters["submitted"] += 1
        future = self._pool.submit(self._submit_sync, tenant, payload,
                                   durable, timeout or self.request_timeout)
        return FleetHandle(self, tenant, future, durable)

    def _submit_sync(self, tenant: str, payload: bytes, durable: bool,
                     timeout: float) -> Dict[str, Any]:
        last_exc: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            name = self.place(tenant)
            spec = self._spec(name)
            with self._lock:
                self._outstanding[name] = (
                    self._outstanding.get(name, 0) + 1)
            try:
                raw = rpc.call(spec.host, spec.port, "POST", "/submit",
                               payload, timeout=timeout + 10.0)
                with self._lock:
                    self.counters["completed"] += 1
                if durable:
                    return json.loads(raw.decode())
                return rpc.decode_result(raw)
            except (BacklogFull, RateLimited, EnergyBudgetExceeded,
                    WalLocked) as exc:
                # typed pressure: honour the worker's own backoff estimate,
                # then re-place — bounded load usually spills the retry to
                # a different worker
                last_exc = exc
                with self._lock:
                    self.counters["retries"] += 1
                time.sleep(min(float(getattr(exc, "retry_after", 0.1)),
                               self.backoff_cap))
            except rpc.RpcError as exc:
                # transport failure: the worker may be mid-death — route
                # around it and let the heartbeat loop make the call
                last_exc = exc
                self._mark_suspect(name)
                with self._lock:
                    self.counters["retries"] += 1
                time.sleep(min(0.05 * (attempt + 1), self.backoff_cap))
            finally:
                with self._lock:
                    self._outstanding[name] = max(
                        0, self._outstanding.get(name, 1) - 1)
        with self._lock:
            self.counters["rejected"] += 1
        assert last_exc is not None
        raise last_exc

    # -- durable-result fetch ------------------------------------------------

    def _resolve_owner(self, name: str) -> str:
        """Follow the adopter chain from the admitting worker to whoever
        holds (or will hold) the work now."""
        seen = set()
        while name not in seen:
            seen.add(name)
            spec = self.manager.worker(name)
            if spec.alive:
                return name
            if spec.adopter is None:
                break
            name = spec.adopter
        raise rpc.RpcError(
            f"no live owner for work admitted at {name!r} "
            f"(adopter chain: {sorted(seen)})")

    def _fetch_result(self, admitted_at: str, cache_key: str, *,
                      timeout: Optional[float] = None) -> Dict[str, Any]:
        deadline = time.monotonic() + (timeout or self.request_timeout)
        with self._lock:
            self.counters["result_fetches"] += 1
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"content hash {cache_key[:12]}… unresolved within "
                    f"the deadline (admitted at {admitted_at})")
            try:
                owner = self._resolve_owner(admitted_at)
                spec = self._spec(owner)
                wait = max(0.5, min(10.0, remaining))
                raw = rpc.call(
                    spec.host, spec.port, "GET",
                    f"/result?key={cache_key}&timeout={wait:.1f}",
                    timeout=wait + 5.0)
                return rpc.decode_result(raw)
            except rpc.RemoteError as exc:
                if exc.kind != "NotFound":
                    raise
                # takeover replay has not landed the key yet — back off
                time.sleep(0.1)
            except rpc.RpcError:
                # owner died under us (possibly mid-failover): re-resolve
                time.sleep(0.1)

    # -- streaming -----------------------------------------------------------

    def stream(self, tenant: str, name: str = "default", *, k: int,
               batch_size: int = 256, checkpoint_every: int = 8,
               seed: int = 0, **cfg_kwargs: Any) -> FleetStream:
        """Open a sticky streaming session: the tenant is pinned to one
        worker and every subsequent submit/stream op follows the pin."""
        kwargs = dict(k=k, batch_size=batch_size,
                      checkpoint_every=checkpoint_every, seed=seed,
                      **cfg_kwargs)
        worker = self.place(tenant)
        with self._lock:
            self._sticky[tenant] = worker
        stream = FleetStream(self, tenant, name, kwargs)
        self._stream_op(tenant, name, "open", open_kwargs=kwargs)
        return stream

    def _stream_op(self, tenant: str, name: str, op: str,
                   payload: bytes = b"", *,
                   open_kwargs: Dict[str, Any], **fields: Any
                   ) -> Dict[str, Any]:
        body = rpc.pack_frame({"op": op, "tenant": tenant, "name": name,
                               "kwargs": open_kwargs, **fields}, payload)
        for attempt in range(self.max_attempts):
            worker = self.place(tenant)     # the sticky pin, while alive
            spec = self._spec(worker)
            try:
                raw = rpc.call(spec.host, spec.port, "POST", "/stream",
                               body, timeout=self.request_timeout)
            except rpc.RemoteError as exc:
                if exc.kind == "NotFound" and op != "open":
                    # the pin moved (failover) and the new worker has no
                    # session yet: re-open there, then retry the op once
                    open_body = rpc.pack_frame(
                        {"op": "open", "tenant": tenant, "name": name,
                         "kwargs": open_kwargs})
                    rpc.call(spec.host, spec.port, "POST", "/stream",
                             open_body, timeout=self.request_timeout)
                    continue
                raise
            except rpc.RpcError:
                self._mark_suspect(worker)
                time.sleep(min(0.05 * (attempt + 1), self.backoff_cap))
                continue
            return rpc.decode_result(raw)
        raise rpc.RpcError(
            f"stream op {op!r} for {tenant}/{name} exhausted retries")

    # -- live reload ---------------------------------------------------------

    def reload(self, changes: Dict[str, Any]) -> Dict[str, Any]:
        """Fan a config reload out to every live worker.

        Each worker validates the whole candidate config before applying
        (see ``ClusteringService.apply_config``), so a bad knob value is
        rejected everywhere rather than applied somewhere.  Returns the
        per-worker epochs; ``converged`` is True when every live worker
        accepted and reports the same (new) epoch.
        """
        epochs: Dict[str, int] = {}
        errors: Dict[str, str] = {}
        for spec in self.manager.live_workers():
            try:
                out = rpc.post_json(spec.host, spec.port, "/reload",
                                    {"changes": dict(changes)},
                                    timeout=30.0)
                epochs[spec.name] = int(out["epoch"])
            except Exception as exc:
                errors[spec.name] = repr(exc)
        with self._lock:
            self.counters["reloads"] += 1
        return {
            "epochs": epochs,
            "errors": errors,
            "converged": (not errors and len(set(epochs.values())) <= 1
                          and bool(epochs)),
        }

    # -- observability -------------------------------------------------------

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Fleet-level aggregation: manager lifecycle state + router
        counters + every live worker's own ``metrics_snapshot()``."""
        fleet = self.manager.fleet_snapshot()
        with self._lock:
            fleet["router"] = {
                **self.counters,
                "outstanding": dict(self._outstanding),
                "sticky_tenants": len(self._sticky),
                "ring_nodes": self.ring.nodes,
            }
        per_worker: Dict[str, Any] = {}
        for spec in self.manager.live_workers():
            try:
                per_worker[spec.name] = rpc.get_json(
                    spec.host, spec.port, "/snapshot", timeout=10.0)
            except (rpc.RpcError, rpc.RemoteError) as exc:
                per_worker[spec.name] = {"error": repr(exc)}
        return {"fleet": fleet, "workers": per_worker}

    def trace(self, trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """One trace's spans merged across every worker that touched it
        (admission on the victim, replay + execution on the adopter end
        up in ONE timeline — same span-id merge rule as the single
        process uses across its own restarts)."""
        merged: Dict[str, Dict[str, Any]] = {}
        path = "/spans" + (f"?id={trace_id}" if trace_id else "")
        for spec in self.manager.live_workers():
            try:
                spans = json.loads(rpc.call(
                    spec.host, spec.port, "GET", path,
                    timeout=10.0).decode())
            except (rpc.RpcError, rpc.RemoteError):
                continue
            for span in spans:
                sid = str(span.get("span_id"))
                prior = merged.get(sid)
                if prior is None or (prior.get("phase") == "start"
                                     and span.get("phase") != "start"):
                    merged[sid] = span
        return sorted(merged.values(),
                      key=lambda s: float(s.get("t0") or 0.0))

    def serve_metrics(self, port: int = 0,
                      host: str = "127.0.0.1") -> TelemetryServer:
        """Fleet scrape endpoint: ``/metrics`` renders ``repro_fleet_*``
        with per-worker labels; ``/trace?id=`` fans out across workers;
        ``/snapshot`` is the raw aggregation."""
        return TelemetryServer(
            self.metrics_snapshot, host=host, port=port,
            prefix="repro_fleet",
            render_fn=render_fleet_prometheus,
            trace_fn=self.trace).start()

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def render_fleet_prometheus(snapshot: Dict[str, Any],
                            prefix: str = "repro_fleet") -> str:
    """Fleet snapshot → Prometheus text: fleet/router gauges plus the
    per-worker series the fleet gate scrapes (``worker`` label)."""
    out = _Lines(prefix)
    fleet = snapshot.get("fleet") or {}
    out.add("workers", fleet.get("n_workers", 0),
            help_text="Workers the manager supervises")
    out.add("workers_alive", fleet.get("alive", 0),
            help_text="Workers currently heartbeating")
    out.add("workers_dead", fleet.get("dead", 0),
            help_text="Workers declared dead")
    out.add("takeovers_total", len(fleet.get("takeovers") or []),
            help_text="WAL takeovers performed after worker death",
            kind="counter")
    for t in fleet.get("takeovers") or []:
        out.add("takeover_replayed_total", t.get("replayed", 0),
                labels={"victim": t.get("victim", ""),
                        "adopter": t.get("adopter", "")},
                help_text="Admitted requests replayed per takeover",
                kind="counter")
    router = fleet.get("router") or {}
    for key, kind in (("submitted", "counter"), ("completed", "counter"),
                      ("retries", "counter"), ("spills", "counter"),
                      ("rejected", "counter"), ("reroutes", "counter"),
                      ("result_fetches", "counter")):
        if key in router:
            out.add(f"router_{key}_total", router[key],
                    help_text=f"Router {key}", kind=kind)
    out.add("router_sticky_tenants", router.get("sticky_tenants", 0),
            help_text="Tenants pinned to a worker by a streaming session")

    workers = fleet.get("workers") or {}
    snaps = snapshot.get("workers") or {}
    for name in sorted(workers):
        lab = {"worker": name}
        spec = workers[name]
        out.add("worker_up", 1.0 if spec.get("alive") else 0.0, labels=lab,
                help_text="1 while the worker heartbeats")
        health = spec.get("health") or {}
        for key, metric in (("queue_depth", "worker_queue_depth"),
                            ("inflight", "worker_inflight"),
                            ("wal_pending", "worker_wal_pending"),
                            ("modeled_watts", "worker_modeled_watts"),
                            ("cap_saturation", "worker_cap_saturation")):
            if key in health:
                out.add(metric, health[key], labels=lab,
                        help_text=f"Per-worker {key} (last heartbeat)")
        if health.get("power_cap_watts") is not None:
            out.add("worker_power_cap_watts", health["power_cap_watts"],
                    labels=lab,
                    help_text="Per-worker configured power cap")
        snap = snaps.get(name) or {}
        totals = snap.get("totals") or {}
        for key, metric in (("requests", "worker_requests_total"),
                            ("cache_hits", "worker_cache_hits_total"),
                            ("failures", "worker_failures_total"),
                            ("modeled_joules",
                             "worker_modeled_joules_total")):
            if key in totals:
                out.add(metric, totals[key], labels=lab,
                        help_text=f"Per-worker {key}", kind="counter")
        if "p99_latency_s" in snap:
            out.add("worker_p99_latency_seconds", snap["p99_latency_s"],
                    labels=lab,
                    help_text="Per-worker p99 latency (window)")
        slo = snap.get("slo") or {}
        for which in ("latency", "errors"):
            burn = slo.get(f"{which}_burn_rate")
            if burn is not None:
                out.add("worker_slo_burn_rate", burn,
                        labels=dict(lab, slo=which),
                        help_text="Per-worker SLO burn rate")
    return out.text()
