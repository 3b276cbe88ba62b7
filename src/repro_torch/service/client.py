"""MiningClient — the async front door: futures, QoS, streaming sessions.

The paper's app blocks the UI thread on one job at a time; a serving system
cannot.  ``MiningClient.submit`` returns a :class:`ResultHandle`
immediately — a future over the request's journey through admission,
batching, lane dispatch, and durable execution — and the caller chooses
when (or whether) to block.  Per-request QoS rides along: ``priority``
picks the admission lane (interactive work overtakes bulk),
``deadline``/``ttl`` bound queueing (an expired request is dropped before
it can occupy a batch slot), and a full backlog surfaces as
:class:`~repro_torch.service.queue.BacklogFull` with a ``retry_after`` estimate
instead of a bare error string.

``stream()`` opens a :class:`~repro_torch.service.session.StreamingSession`:
unbounded point streams folded through mini-batch K-Means with the model
state checkpointed per tenant, so a stream survives process death the same
way a suspended batch does.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.service.queue import PRIORITY_NORMAL, MiningRequest
from repro_torch.service.service import ClusteringService
from repro_torch.service.session import StreamingSession


class ResultHandle:
    """Future over one mining request (concurrent.futures-flavoured).

    Thin and immutable: all state lives on the underlying
    :class:`MiningRequest`, which the service threads complete.
    """

    def __init__(self, request: MiningRequest) -> None:
        self._request = request

    # -- future protocol -----------------------------------------------------

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until complete; raises the request's error on failure."""
        return self._request.wait(timeout)

    def exception(self,
                  timeout: Optional[float] = None) -> Optional[BaseException]:
        return self._request.exception(timeout)

    def done(self) -> bool:
        return self._request.done()

    def cancel(self) -> bool:
        """Best-effort: succeeds only before the batcher claims the request
        (after that the batch is already a durable job)."""
        return self._request.cancel()

    def add_done_callback(
            self, fn: Callable[["ResultHandle"], None]) -> None:
        """Run ``fn(handle)`` when the request completes (immediately if it
        already has).  Fires on a service thread; keep callbacks short."""
        self._request.add_done_callback(lambda _req: fn(self))

    # -- metadata ------------------------------------------------------------

    @property
    def request_id(self) -> int:
        return self._request.request_id

    @property
    def tenant(self) -> str:
        return self._request.tenant

    @property
    def cache_hit(self) -> bool:
        return self._request.cache_hit

    @property
    def cache_key(self) -> Optional[str]:
        """Content hash of (algo, params, data) — stable across replays."""
        return self._request.cache_key

    @property
    def job_id(self) -> Optional[int]:
        """Durable batch job id once the request is batched (None before)."""
        return self._request.job_id

    @property
    def trace_id(self) -> Optional[str]:
        """Id of the request's end-to-end trace (stable across replays)."""
        return self._request.trace_id

    @property
    def latency(self) -> Optional[float]:
        return self._request.latency

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return (f"ResultHandle(request_id={self.request_id}, "
                f"tenant={self.tenant!r}, {state})")


class MiningClient:
    """Async client over a :class:`ClusteringService` engine.

    Either owns its engine (pass ``workdir`` + engine kwargs; the client
    starts it and ``close()`` stops it) or attaches to one already running
    (pass ``service=``).
    """

    def __init__(self, workdir: Optional[str] = None, *,
                 service: Optional[ClusteringService] = None,
                 **service_kwargs: Any) -> None:
        if (workdir is None) == (service is None):
            raise ValueError("pass exactly one of workdir= or service=")
        if service is not None:
            if service_kwargs:
                raise ValueError(
                    "service_kwargs only apply when the client owns the "
                    "engine (workdir=...)")
            self.service = service
            self._owns_service = False
        else:
            self.service = ClusteringService(workdir, **service_kwargs)
            self._owns_service = True
            self.service.start()

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "MiningClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, preempt: bool = False, drain: bool = False) -> None:
        """Stop an owned engine (fails all pending handles); attached
        engines are left running for their owner.  ``drain=True`` first
        stops admitting (new submits bounce with a retryable
        ``BacklogFull``) and lets queued + in-flight work finish, so a
        rolling restart hands over a clean, fully-consumed WAL."""
        if self._owns_service:
            self.service.stop(preempt=preempt, drain=drain)

    # -- the async API -------------------------------------------------------

    def submit(
        self,
        tenant: str,
        algo: str,
        data: np.ndarray,
        *,
        params: Dict[str, Any],
        executor: Optional[str] = None,
        priority: int = PRIORITY_NORMAL,
        deadline: Optional[float] = None,
        ttl: Optional[float] = None,
    ) -> ResultHandle:
        """Submit one mining request; returns immediately.

        ``priority`` — admission lane (``PRIORITY_INTERACTIVE`` overtakes
        ``PRIORITY_NORMAL`` overtakes ``PRIORITY_BATCH``).
        ``deadline`` — absolute epoch seconds; ``ttl`` — relative seconds
        (the tighter of the two wins).  A request still queued past its
        deadline fails with ``RequestDropped`` and never occupies a batch
        slot.  Raises :class:`BacklogFull` (with ``retry_after``) when the
        queue sheds load.
        """
        req = self.service._submit(
            tenant, algo, data, params=params, executor=executor,
            priority=priority, deadline=deadline, ttl=ttl)
        return ResultHandle(req)

    def stream(
        self,
        tenant: str,
        name: str = "default",
        *,
        k: int,
        batch_size: int = 256,
        checkpoint_every: int = 8,
        seed: int = 0,
        **cfg_kwargs: Any,
    ) -> StreamingSession:
        """Open (or re-open) a per-tenant streaming K-Means session.

        State persists under the service workdir, so re-opening the same
        ``(tenant, name)`` after a crash or SIGTERM resumes the model from
        its last checkpoint.
        """
        root = os.path.join(self.service.workdir, "streams")
        cfg_kwargs.setdefault("device", self.service.device)
        return StreamingSession(
            root, tenant, name, k=k, batch_size=batch_size,
            checkpoint_every=checkpoint_every, seed=seed, **cfg_kwargs)

    def metrics(self) -> Dict[str, Any]:
        return self.service.metrics_snapshot()

    def trace(self, trace_id: str):
        """All recorded spans of one request's trace, oldest first —
        merged across process lifetimes when the event log is on."""
        return self.service.export_trace(trace_id)

    def resume_suspended(self):
        """Complete batches a previous (killed) process left SUSPENDED."""
        return self.service.resume_suspended()

    def recover(self, *, replay_rate: Optional[float] = None,
                replay_burst: int = 8) -> Dict[str, Any]:
        """Full restart path: resume suspended batches, then replay every
        admitted-but-unbatched request from the write-ahead admission log.

        ``replay_rate`` (requests/s, ``replay_burst`` token bucket) shapes
        the replay so a recovery storm shares admission with live traffic
        instead of instantly tripping ``BacklogFull``.

        Returns the engine's recovery summary with ``requests`` wrapped as
        :class:`ResultHandle` futures — wait on them to drive the replayed
        work to completion (replays of already-completed content are cache
        hits and resolve instantly).
        """
        summary = self.service.recover(replay_rate=replay_rate,
                                       replay_burst=replay_burst)
        summary["requests"] = [ResultHandle(r) for r in summary["requests"]]
        return summary

    def replay_foreign(self, wal_root: str, *,
                       replay_rate: Optional[float] = None,
                       replay_burst: int = 8) -> Dict[str, Any]:
        """Failover takeover: replay a dead peer's admission log through
        this client's engine (see the engine method for the durability
        ordering).  Raises ``WalLocked`` while the peer is still alive."""
        summary = self.service.replay_foreign(
            wal_root, replay_rate=replay_rate, replay_burst=replay_burst)
        summary["requests"] = [ResultHandle(r) for r in summary["requests"]]
        return summary
