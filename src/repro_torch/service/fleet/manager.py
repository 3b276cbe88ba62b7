"""WorkerManager: spawn, supervise, and fail over fleet worker processes.

The manager owns the fleet's *lifecycle* half (the router owns routing):

- **Spawn.**  N worker processes (``python -m
  repro_torch.service.fleet.worker``), each a fresh interpreter (never a
  fork of a process that has touched CUDA) over its own workdir
  ``<root>/<name>/`` — so each holds its own WAL single-writer lock and,
  on the card, its own CUDA context.  A worker announces its ephemeral
  RPC port by writing an announce file atomically; the manager blocks on
  those files at start, one worker after another, so at most one worker
  at a time builds a kernel the parent has not built.  A worker that
  exits before announcing raises with the tail of its stderr
  (``<root>/<name>.stderr``).
- **Heartbeat.**  A supervisor thread polls every worker: first
  ``Popen.poll()`` (an exited process needs no timeout to be declared
  dead), then ``GET /healthz`` with a short timeout.  The health payload
  (queue depth, WAL pending, SLO burn, energy) is cached on the spec —
  the router reads it for placement, operators via ``fleet_snapshot()``.
- **Failover.**  A worker that misses ``miss_deadline`` seconds of
  heartbeats is SIGKILLed (a wedged process must not keep its WAL lock on
  life support), then — as for any dead worker — the manager picks the
  least-loaded survivor and POSTs ``/takeover`` with the victim's WAL
  root.  The survivor's :meth:`ClusteringService.replay_foreign` replays
  every unconsumed admit through its own front door, making "admitted
  means durable" a *fleet-level* guarantee.  ``WalLocked`` during the
  race with the victim's death is retryable and retried.

Death and takeover are announced to subscribers (``on_death``) so the
router can drop the victim from the hash ring and re-pin sticky tenants
to the adopter before the takeover replay even lands.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.service.fleet import rpc
from repro_torch.service.wal import WalLocked

logger = logging.getLogger(__name__)


class WorkerSpec:
    """One supervised worker process, as the manager sees it."""

    def __init__(self, name: str, workdir: str) -> None:
        self.name = name
        self.workdir = workdir
        self.host = "127.0.0.1"
        self.port = 0
        self.pid: Optional[int] = None
        self.proc: Optional[subprocess.Popen] = None
        self.alive = False
        self.last_ok = 0.0
        self.health: Dict[str, Any] = {}
        self.adopter: Optional[str] = None   # who took over our WAL
        self.restarting = False              # mid rolling-restart: not dead
        self.spawn_s: Optional[float] = None  # Popen to announce, seconds
        # seconds from Popen to the end of each start-up phase the worker
        # marked: imports, service (constructor), kernels (libraries
        # found or built), start (warm-up, recover, RPC door bound)
        self.startup: Dict[str, float] = {}

    @property
    def wal_root(self) -> str:
        return os.path.join(self.workdir, "wal")

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "workdir": self.workdir,
                "host": self.host, "port": self.port, "pid": self.pid,
                "alive": self.alive, "adopter": self.adopter,
                "restarting": self.restarting, "spawn_s": self.spawn_s,
                "startup": dict(self.startup),
                "health": dict(self.health)}


def _src_pythonpath() -> str:
    """The spawned worker must import the same ``repro_torch`` this
    process runs, regardless of how the parent was launched."""
    import repro_torch
    # the import root is the directory that holds the package's own
    # directory (repro_torch/__init__.py)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    return f"{src}{os.pathsep}{existing}" if existing else src


def _tail(path: str, n_bytes: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(max(0, os.path.getsize(path) - n_bytes))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class WorkerManager:
    """Spawns and supervises N worker processes under one fleet root.

    ``worker_config`` is the ClusteringService kwargs every worker gets
    (``"device": "cpu"`` runs them on the host; the default is the card);
    ``overrides`` maps a worker name to kwargs merged on top (used by
    tests and the gates to give one worker a distinct batching shape).
    ``replay_rate`` shapes takeover replays (tokens/s; None = full rate).
    ``spawn_timeout`` covers one worker's start: the torch import, its
    CUDA context, loading the kernel libraries and the exec-cache
    warm-up.
    """

    def __init__(self, root: str, n_workers: int = 2, *,
                 worker_config: Optional[Dict[str, Any]] = None,
                 overrides: Optional[Dict[str, Dict[str, Any]]] = None,
                 heartbeat_interval: float = 0.5,
                 miss_deadline: Optional[float] = None,
                 replay_rate: Optional[float] = None,
                 spawn_timeout: float = 120.0,
                 fault_specs: Optional[Dict[str, str]] = None,
                 fault_ledger: Optional[str] = None,
                 standbys: Optional[Dict[str, str]] = None) -> None:
        if n_workers < 1:
            raise ValueError("a fleet needs at least one worker")
        self.root = root
        self.n_workers = int(n_workers)
        self.worker_config = dict(worker_config or {})
        self.overrides = {k: dict(v) for k, v in (overrides or {}).items()}
        self.heartbeat_interval = float(heartbeat_interval)
        self.miss_deadline = (float(miss_deadline) if miss_deadline
                              is not None else 6 * self.heartbeat_interval)
        self.replay_rate = replay_rate
        self.spawn_timeout = float(spawn_timeout)
        # crash-matrix support: arm one worker's REPRO_FAULT without
        # leaking the parent process's own spec into every child
        self.fault_specs = dict(fault_specs or {})
        self.fault_ledger = fault_ledger
        self.standbys = dict(standbys or {})   # name -> "host:port"
        self.workers: Dict[str, WorkerSpec] = {}
        self.takeovers: List[Dict[str, Any]] = []
        self.restarts: List[Dict[str, Any]] = []
        self._subscribers: List[Callable[[str, Optional[str]], None]] = []
        self._restart_subs: List[Callable[[str, str], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._running = False

    # -- membership events ---------------------------------------------------

    def on_death(self, fn: Callable[[str, Optional[str]], None]) -> None:
        """Subscribe ``fn(victim_name, adopter_name)`` — called when a
        worker is declared dead, *before* the takeover replay runs, so
        routing updates don't wait on replay I/O."""
        self._subscribers.append(fn)

    def _announce_death(self, victim: str, adopter: Optional[str]) -> None:
        for fn in list(self._subscribers):
            try:
                fn(victim, adopter)
            except Exception:
                logger.exception("fleet death subscriber raised")

    def on_restart(self, fn: Callable[[str, str], None]) -> None:
        """Subscribe ``fn(worker_name, phase)`` to rolling-restart
        lifecycle events; ``phase`` is ``"drain"`` (stop routing new work
        to this worker) or ``"restored"`` (successor is live)."""
        self._restart_subs.append(fn)

    def _announce_restart(self, name: str, phase: str) -> None:
        for fn in list(self._restart_subs):
            try:
                fn(name, phase)
            except Exception:
                logger.exception("fleet restart subscriber raised")

    # -- spawn ---------------------------------------------------------------

    def _spawn(self, name: str) -> WorkerSpec:
        spec = WorkerSpec(name, os.path.join(self.root, name))
        os.makedirs(spec.workdir, exist_ok=True)
        announce = os.path.join(self.root, f"{name}.announce.json")
        try:
            os.unlink(announce)
        except OSError:
            pass
        cfg = dict(self.worker_config)
        cfg.update(self.overrides.get(name, {}))
        env = dict(os.environ)
        env["PYTHONPATH"] = _src_pythonpath()
        env.pop("REPRO_FAULT", None)
        env.pop("REPRO_FAULT_LEDGER", None)
        if name in self.fault_specs:
            env["REPRO_FAULT"] = self.fault_specs[name]
            if self.fault_ledger is not None:
                env["REPRO_FAULT_LEDGER"] = self.fault_ledger
        argv = [sys.executable, "-m", "repro_torch.service.fleet.worker",
                "--workdir", spec.workdir, "--announce", announce,
                "--name", name, "--config", json.dumps(cfg)]
        if name in self.standbys:
            argv += ["--standby", self.standbys[name]]
        if self.replay_rate is not None:
            argv += ["--replay-rate", str(self.replay_rate)]
        stderr_path = os.path.join(self.root, f"{name}.stderr")
        t0, t0_wall = time.monotonic(), time.time()
        with open(stderr_path, "ab") as stderr:
            spec.proc = subprocess.Popen(
                argv, env=env, stdout=subprocess.DEVNULL, stderr=stderr)
        deadline = t0 + self.spawn_timeout
        while time.monotonic() < deadline:
            if spec.proc.poll() is not None:
                raise RuntimeError(
                    f"fleet worker {name} exited with "
                    f"{spec.proc.returncode} before announcing; its "
                    f"stderr ends:\n{_tail(stderr_path)}")
            try:
                with open(announce) as f:
                    info = json.load(f)
                break
            except (OSError, ValueError):
                time.sleep(0.05)
        else:
            spec.proc.kill()
            raise RuntimeError(
                f"fleet worker {name} did not announce within "
                f"{self.spawn_timeout:.0f}s")
        spec.spawn_s = time.monotonic() - t0
        spec.startup = {phase: t - t0_wall
                        for phase, t in (info.get("marks") or {}).items()}
        spec.host, spec.port = info["host"], int(info["port"])
        spec.pid = int(info["pid"])
        spec.alive = True
        spec.last_ok = time.monotonic()
        return spec

    def start(self) -> "WorkerManager":
        if self._running:
            return self
        os.makedirs(self.root, exist_ok=True)
        for i in range(self.n_workers):
            name = f"worker-{i}"
            self.workers[name] = self._spawn(name)
        self._stop.clear()
        self._thread = threading.Thread(target=self._heartbeat_loop,
                                        name="fleet-heartbeat", daemon=True)
        self._thread.start()
        self._running = True
        return self

    # -- supervision ---------------------------------------------------------

    def live_workers(self) -> List[WorkerSpec]:
        with self._lock:
            return [w for w in self.workers.values() if w.alive]

    def worker(self, name: str) -> WorkerSpec:
        return self.workers[name]

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            for spec in list(self.workers.values()):
                if not spec.alive or spec.restarting:
                    continue
                # an exited process is dead without waiting out a timeout
                if spec.proc is not None and spec.proc.poll() is not None:
                    self._declare_dead(spec, reason="exited")
                    continue
                try:
                    health = rpc.get_json(
                        spec.host, spec.port, "/healthz",
                        timeout=max(0.2, self.heartbeat_interval))
                except (rpc.RpcError, rpc.RemoteError):
                    if (time.monotonic() - spec.last_ok
                            > self.miss_deadline):
                        self._kill(spec)
                        self._declare_dead(spec, reason="missed heartbeats")
                    continue
                spec.health = health
                spec.last_ok = time.monotonic()

    def _kill(self, spec: WorkerSpec) -> None:
        """SIGKILL, not SIGTERM: a worker that stopped heartbeating may be
        wedged holding its WAL lock — only process death releases it."""
        if spec.proc is not None:
            try:
                spec.proc.kill()
            except OSError:
                pass

    def _declare_dead(self, spec: WorkerSpec, *, reason: str) -> None:
        with self._lock:
            # a restarting worker's planned exit is not a death — the
            # rolling restart owns its lifecycle and spawns the successor
            if not spec.alive or spec.restarting:
                return
            spec.alive = False
        # the lock must actually be free before a survivor can adopt the
        # WAL — reap the corpse first (kill() above, or a natural exit)
        if spec.proc is not None:
            try:
                spec.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover - wedged
                logger.error("fleet worker %s refused to die", spec.name)
        adopter = self._pick_adopter()
        spec.adopter = adopter.name if adopter is not None else None
        logger.warning("fleet worker %s dead (%s); adopter=%s",
                       spec.name, reason, spec.adopter)
        self._announce_death(spec.name, spec.adopter)
        if adopter is not None:
            self._takeover(spec, adopter, reason=reason)

    def _pick_adopter(self) -> Optional[WorkerSpec]:
        """Least-loaded survivor (last heartbeat's queue depth) adopts."""
        live = self.live_workers()
        if not live:
            return None
        return min(live, key=lambda w: (
            int(w.health.get("queue_depth", 0))
            + int(w.health.get("inflight", 0))))

    def _takeover(self, victim: WorkerSpec, adopter: WorkerSpec, *,
                  reason: str) -> None:
        record: Dict[str, Any] = {
            "victim": victim.name, "adopter": adopter.name,
            "reason": reason, "wal_root": victim.wal_root}
        body = {"wal_root": victim.wal_root}
        if self.replay_rate is not None:
            body["replay_rate"] = self.replay_rate
        for attempt in range(10):
            try:
                summary = rpc.post_json(adopter.host, adopter.port,
                                        "/takeover", body, timeout=120.0)
            except WalLocked as exc:
                # racing the victim's death: the kernel releases the lock
                # when the process is fully gone — back off and retry
                time.sleep(exc.retry_after)
                continue
            except (rpc.RpcError, rpc.RemoteError) as exc:
                record["error"] = repr(exc)
                time.sleep(0.2 * (attempt + 1))
                continue
            record.update(summary)
            record.pop("error", None)
            break
        self.takeovers.append(record)

    # -- operator controls ---------------------------------------------------

    def fail_worker(self, name: str) -> None:
        """Test/gate hook: SIGKILL a worker NOW and run the failover path
        synchronously instead of waiting for the heartbeat loop to notice
        (the loop's poll() would find the corpse anyway)."""
        spec = self.workers[name]
        self._kill(spec)
        self._declare_dead(spec, reason="killed by operator")

    def rolling_restart(self, *, drain_timeout: float = 30.0
                        ) -> List[Dict[str, Any]]:
        """Restart the whole fleet one worker at a time, losing nothing.

        Per worker: announce ``drain`` (the router stops placing new work
        there), SIGTERM (the worker finishes in-flight requests, consumes
        their WAL entries, and releases its lock), wait for a clean exit,
        spawn a successor over the *same* workdir (its startup
        ``recover()`` replays any unconsumed admitted tail), then
        announce ``restored``.  At least ``n_workers - 1`` workers serve
        at every instant, so admitted requests are never lost and new
        submits only ever see retryable backpressure.
        """
        summary: List[Dict[str, Any]] = []
        for name in sorted(self.workers):
            spec = self.workers[name]
            if not spec.alive:
                continue
            old_pid = spec.pid
            spec.restarting = True
            self._announce_restart(name, "drain")
            t0 = time.monotonic()
            try:
                if spec.proc is not None and spec.proc.poll() is None:
                    try:
                        spec.proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
                    try:
                        spec.proc.wait(timeout=drain_timeout)
                    except subprocess.TimeoutExpired:
                        logger.error("fleet worker %s did not drain in "
                                     "%.0fs; killing", name, drain_timeout)
                        self._kill(spec)
                        spec.proc.wait(timeout=10)
                successor = self._spawn(name)
                with self._lock:
                    self.workers[name] = successor
            except Exception:
                spec.restarting = False
                raise
            self._announce_restart(name, "restored")
            record = {"worker": name, "old_pid": old_pid,
                      "new_pid": successor.pid,
                      "duration_s": time.monotonic() - t0}
            self.restarts.append(record)
            summary.append(record)
            logger.info("fleet worker %s restarted: pid %s -> %s",
                        name, old_pid, successor.pid)
        return summary

    def fleet_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            workers = {n: s.as_dict() for n, s in self.workers.items()}
        alive = sum(1 for w in workers.values() if w["alive"])
        return {
            "workers": workers,
            "n_workers": len(workers),
            "alive": alive,
            "dead": len(workers) - alive,
            "takeovers": [dict(t) for t in self.takeovers],
            "restarts": [dict(r) for r in self.restarts],
        }

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """SIGTERM every live worker (they drain-stop: finish in-flight,
        consume WAL entries, release locks), escalating to SIGKILL past
        ``timeout``.  ``drain=False`` goes straight to SIGKILL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        procs = [s.proc for s in self.workers.values()
                 if s.proc is not None and s.proc.poll() is None]
        if drain:
            for p in procs:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
            deadline = time.monotonic() + timeout
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                    p.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        for spec in self.workers.values():
            spec.alive = False
        self._running = False

    def __enter__(self) -> "WorkerManager":
        return self.start()

    def __exit__(self, *_exc: Any) -> None:
        self.stop()
