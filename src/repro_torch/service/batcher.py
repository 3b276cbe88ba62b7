"""Micro-batching scheduler: coalesce compatible requests into padded batches.

Compatible means *same compiled program*: same algorithm, feature dimension,
and algorithm parameters (eps/min_pts for DBSCAN, k/init/tol for K-Means).
Items inside a batch are padded to a shared point-count bucket chosen by a
pluggable :class:`~repro_torch.service.bucketing.BucketPolicy` (default: the next
power of two), so every batch with the same key and bucket reuses one
prepared step — the service amortises setup (the paper's dominant GPU
"setup time", Fig. 6) across requests instead of paying it per request.  The
policy also *observes* every drained request's shape, which is how the
``adaptive`` policy learns its bucket edges from live traffic (see
``docs/bucketing_study.md`` for the measured policy comparison).

Flush policy: a staged group is emitted when it reaches ``max_batch``
requests (occupancy 1.0) or when its oldest request has waited
``max_wait_s`` (the latency ceiling a half-empty batch is allowed to add).

Oversized requests — working set over the per-device memory budget (the
``oversized`` predicate, usually ``ParadigmRegistry.oversized``) — bypass
coalescing entirely: each becomes a singleton batch the moment it drains.
There is nothing to amortise (no other request shares its compiled
program's shape) and no reason to wait; the batch is marked ``oversized``
and the cost model routes it to the distributed paradigm.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.service.bucketing import BucketPolicy, Pow2Policy, pow2_bucket
from repro_torch.service.queue import (
    AdmissionQueue,
    MiningRequest,
    RequestDropped,
    canonical_params,
)


@dataclasses.dataclass(frozen=True)
class BatchKey:
    """Compatibility class of a request: one key == one compiled program.

    The explicit executor override is part of the key — a request pinned to
    ``torch-ref`` must never ride in a ``cuda-kernel`` batch.
    """

    algo: str
    features: int
    params: tuple  # canonical_params() view
    executor: Optional[str] = None

    @staticmethod
    def for_request(req: MiningRequest) -> "BatchKey":
        return BatchKey(
            algo=req.algo,
            features=req.features,
            params=canonical_params(req.algo, req.params),
            executor=req.executor,
        )

    @property
    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)


_BATCH_IDS = itertools.count(1)


@dataclasses.dataclass
class MicroBatch:
    key: BatchKey
    requests: List[MiningRequest]
    capacity: int                 # max_batch at formation time
    created: float = dataclasses.field(default_factory=time.time)
    batch_id: int = dataclasses.field(default_factory=lambda: next(_BATCH_IDS))
    oversized: bool = False       # singleton over the per-device budget
    n_pad: Optional[int] = None   # policy bucket, set at formation time

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def occupancy(self) -> float:
        """Filled fraction of the batch's slots (1.0 = full coalesce)."""
        return len(self.requests) / max(1, self.capacity)

    @property
    def n_max(self) -> int:
        """Shared padded point-count bucket for every item.

        Set by the batcher's bucket policy at formation; a batch built by
        hand (tests) falls back to the pow2 default."""
        if self.n_pad is not None:
            return self.n_pad
        return pow2_bucket(max(r.n_points for r in self.requests))

    @property
    def priority(self) -> int:
        """The batch rides at its most urgent member's priority."""
        return min(r.priority for r in self.requests)


class MicroBatcher:
    """Stages drained requests per key and flushes full or ripe groups."""

    def __init__(
        self,
        queue: AdmissionQueue,
        *,
        max_batch: int = 8,
        max_wait_s: float = 0.02,
        oversized: Optional[Callable[[MiningRequest], bool]] = None,
        bucket_policy: Optional[BucketPolicy] = None,
        joinable: Optional[Callable[[BatchKey], bool]] = None,
        join_defer_s: float = 0.25,
    ) -> None:
        self.queue = queue
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.oversized = oversized
        self.policy = bucket_policy if bucket_policy is not None \
            else Pow2Policy()
        # continuous-batching hand-off: when ``joinable(key)`` says an
        # in-flight batch with this key is accepting joiners, a ripe (but
        # not full) staged group holds for up to ``join_defer_s`` extra so
        # the batch's iteration boundary can claim it via take_joinable —
        # joining a hot batch beats forming a fresh one behind it on the
        # same lane.  The deferral is bounded: past the grace window the
        # group forms normally (an always-full batch must not starve it).
        self.joinable = joinable
        self.join_defer_s = join_defer_s
        self._lock = threading.Lock()
        self._staged: Dict[BatchKey, List[MiningRequest]] = {}

    def _bucket(self, requests: List[MiningRequest]) -> int:
        """Padded point count for a batch, from the policy (pow2 on a
        failing policy — a bad fit must degrade padding, not drop work)."""
        n = max(r.n_points for r in requests)
        try:
            b = int(self.policy.bucket(n))
        except Exception:
            return pow2_bucket(n)
        return b if b >= n else pow2_bucket(n)

    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._staged.values())

    def take_joinable(
        self,
        key: BatchKey,
        n_pad: int,
        limit: int,
        now: Optional[float] = None,
    ) -> List[MiningRequest]:
        """Claim up to ``limit`` staged requests that can JOIN an in-flight
        batch: same :class:`BatchKey` (same compiled program) and point
        count within the batch's padded bucket (a join is a host-side data
        swap into a freed slot — it must never change the compiled shape).

        Called by the continuous-batching boundary hook from the executor
        thread, racing ``poll()`` on the dispatch thread: claims go through
        ``claim_for_batch`` like everywhere else, so a request is handed to
        exactly one of them.
        """
        if limit <= 0:
            return []
        now = time.time() if now is None else now
        taken: List[MiningRequest] = []
        with self._lock:
            group = self._staged.get(key)
            if not group:
                return []
            keep: List[MiningRequest] = []
            for r in group:
                if (len(taken) < limit and not r.done()
                        and not r.expired(now) and r.n_points <= n_pad
                        and r.claim_for_batch(now)):
                    taken.append(r)
                else:
                    keep.append(r)
            if keep:
                self._staged[key] = keep
            else:
                del self._staged[key]
        return taken

    def _form(self, key: BatchKey, now: float) -> Optional[MicroBatch]:
        group = self._staged[key]
        take: List[MiningRequest] = []
        idx = 0
        while idx < len(group) and len(take) < self.max_batch:
            r = group[idx]
            idx += 1
            # atomic claim: a concurrent cancel() either beats the claim
            # (request dropped here) or loses (cancel() returns False)
            if r.claim_for_batch(now):
                take.append(r)
        rest = group[idx:]
        if rest:
            self._staged[key] = rest
        else:
            del self._staged[key]
        if not take:
            return None
        return MicroBatch(key=key, requests=take, capacity=self.max_batch,
                          n_pad=self._bucket(take))

    def _prune(self, now: float) -> List[MiningRequest]:
        """Drop cancelled/expired requests from the staged groups so they
        never occupy a batch slot; returns the newly-expired ones (failed
        by the caller, outside the lock)."""
        dead: List[MiningRequest] = []
        for key in list(self._staged.keys()):
            live: List[MiningRequest] = []
            for r in self._staged[key]:
                if r.done():           # cancelled while staged
                    continue
                if r.expired(now):
                    dead.append(r)
                    continue
                live.append(r)
            if live:
                self._staged[key] = live
            else:
                del self._staged[key]
        return dead

    def _stage(self, drained: List[MiningRequest]) -> None:
        now = time.time()
        for req in drained:
            if req.staged == 0.0:
                # splits queue_wait (submit -> drained into staging) from
                # batch_wait (staged -> claimed) in the request's trace
                req.staged = now
            self._staged.setdefault(
                BatchKey.for_request(req), []).append(req)

    def _bypass_oversized(
        self, drained: List[MiningRequest], now: float,
    ) -> tuple:
        """Split drained requests into (to-stage, singleton batches).

        An oversized request never waits for batch-mates: it is claimed and
        emitted as a capacity-1 batch immediately.  A failing predicate
        falls back to normal staging (the request still runs, just
        unsharded), and a request that loses its claim to a concurrent
        cancel is dropped here like everywhere else.
        """
        if self.oversized is None:
            return drained, []
        normal: List[MiningRequest] = []
        singles: List[MicroBatch] = []
        for req in drained:
            try:
                big = bool(self.oversized(req))
            except Exception:
                big = False
            if not big:
                normal.append(req)
            elif req.claim_for_batch(now):
                singles.append(MicroBatch(
                    key=BatchKey.for_request(req), requests=[req],
                    capacity=1, oversized=True,
                    n_pad=self._bucket([req])))
        return normal, singles

    def _observe(self, shapes: List[int]) -> None:
        """Feed the drained shapes to the bucket policy (how the adaptive
        policy learns its edges).  Called AFTER this cycle's batches are
        formed: an observation can trigger a re-fit, and the fit must
        never delay the batches already in hand (it only informs future
        cycles anyway).  Policies must never take the dispatch loop down.
        """
        for n in shapes:
            try:
                self.policy.observe(n)
            except Exception:
                pass

    def _keys_by_priority(self) -> List[BatchKey]:
        """Staged groups ordered most-urgent-first, so priority carries
        through the staging layer, not just the admission queue."""
        return sorted(
            self._staged.keys(),
            key=lambda k: min(r.priority for r in self._staged[k]))

    @staticmethod
    def _fail_expired(dead: List[MiningRequest]) -> None:
        for r in dead:
            r.fail(RequestDropped(
                f"request {r.request_id} missed its deadline while staged "
                f"for batching; never dispatched"))

    def poll(self, now: Optional[float] = None) -> List[MicroBatch]:
        """Drain the admission queue, then flush every full or ripe group."""
        now = time.time() if now is None else now
        # drain outside the batcher lock: expired requests fail inside
        # drain(), and completion callbacks must never run under our lock
        drained = self.queue.drain(now=now)
        shapes = [r.n_points for r in drained]
        drained, batches = self._bypass_oversized(drained, now)
        with self._lock:
            self._stage(drained)
            dead = self._prune(now)
            for key in self._keys_by_priority():
                while key in self._staged:
                    group = self._staged[key]
                    if len(group) < self.max_batch:
                        waited = now - min(r.submitted for r in group)
                        if waited < self.max_wait_s:
                            break
                        if (waited < self.max_wait_s + self.join_defer_s
                                and self._join_deferred(key)):
                            break
                    batch = self._form(key, now)
                    if batch is not None:
                        batches.append(batch)
        self._fail_expired(dead)
        self._observe(shapes)
        return batches

    def _join_deferred(self, key: BatchKey) -> bool:
        """Should a ripe group hold for an in-flight batch's boundary?
        A failing hint must never stall dispatch — default to forming."""
        if self.joinable is None:
            return False
        try:
            return bool(self.joinable(key))
        except Exception:
            return False

    def flush_all(self, now: Optional[float] = None) -> List[MicroBatch]:
        """Emit everything staged regardless of deadline (shutdown drain)."""
        now = time.time() if now is None else now
        drained = self.queue.drain(now=now)
        shapes = [r.n_points for r in drained]
        drained, batches = self._bypass_oversized(drained, now)
        with self._lock:
            self._stage(drained)
            dead = self._prune(now)
            for key in self._keys_by_priority():
                while key in self._staged:
                    batch = self._form(key, now)
                    if batch is not None:
                        batches.append(batch)
        self._fail_expired(dead)
        self._observe(shapes)
        return batches
