"""Admission queue — priority lanes, deadlines, per-tenant fairness.

The service front door.  Requests land in per-tenant FIFOs inside priority
lanes and are drained strict-priority-first, round-robin within a lane, so
small interactive requests overtake bulk work and one chatty tenant cannot
starve the rest (the paper's single-user activity generalised to many
users).  Backlog bounds are enforced at admission: a full queue rejects
with :class:`BacklogFull` — now carrying the tenant, the observed depth,
and a ``retry_after`` estimate derived from the recent drain rate — instead
of buffering unboundedly; load shedding happens at the door, not by OOM in
the batcher.

Per-request QoS: ``priority`` picks the lane, ``deadline``/``ttl`` bound
how long a request may wait.  A request whose deadline passes while it is
still queued is failed with :class:`RequestDropped` at drain time and never
occupies a batch slot; a request cancelled through its handle is likewise
skipped.

Per-tenant *rate* is bounded by a token bucket at the door
(``tenant_rate`` requests/s refill, ``tenant_burst`` capacity): a tenant
over its rate is rejected with :class:`RateLimited` carrying the exact
``retry_after`` until its next token — backlog bounds protect queue
*depth*, the bucket protects arrival *rate*, so a bursty tenant cannot
monopolise drain capacity even while the backlog has room.

Per-tenant *energy* is bounded the same way (``tenant_joule_rate``
joules/s refill, ``tenant_joule_burst`` capacity): each request is
priced by the service's ``joule_cost`` hook (the device-class model of
:mod:`repro_torch.service.energy` over the dispatch work estimate) and a
tenant whose budget cannot cover it is rejected with
:class:`EnergyBudgetExceeded` carrying the exact ``retry_after`` until
the deficit refills.  Rate protects the *door*, joules protect the
*battery* — the paper's energy axis enforced at admission.

Oversized requests (working set beyond one device's memory budget) are
admitted like any other when the service can shard them — the
``too_large`` hook only bounces them (:class:`RequestTooLarge`) on
services without a distributed paradigm, where they could never execute.

Durability note: the admission queue itself is in-memory, but **admitted
means durable** — the service records every request in the write-ahead
admission log (:mod:`repro_torch.service.wal`) *before* it enters this queue,
and only marks the entry consumed once the request's batch job writes its
step-0 checkpoint (see :mod:`repro_torch.service.executor`).  A process killed
with requests still queued here loses nothing:
:meth:`~repro_torch.service.service.ClusteringService.recover` replays the
unconsumed log entries through admission on restart.  (Before the WAL,
only batched requests survived — the paper's model, where only jobs
already handed to WorkManager outlive the activity.)
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

ALGORITHMS = ("dbscan", "kmeans")

# Per-request parameters that never affect batch compatibility (carried per
# item inside a batch rather than in its key).
PER_ITEM_PARAMS = ("seed",)

# Priority lanes, drained strict-priority-first (lower value = sooner).
PRIORITY_INTERACTIVE = 0
PRIORITY_NORMAL = 1
PRIORITY_BATCH = 2


class BacklogFull(RuntimeError):
    """Admission rejected: global or per-tenant backlog bound hit.

    Structured so clients can back off instead of parsing a message:
    ``tenant`` (None when the *global* bound tripped), ``depth`` (the
    backlog that was full), ``limit`` (its bound), and ``retry_after``
    (seconds; estimated from the queue's recent drain rate).
    """

    def __init__(self, message: str, *, tenant: Optional[str] = None,
                 depth: int = 0, limit: int = 0,
                 retry_after: float = 0.1) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.depth = depth
        self.limit = limit
        self.retry_after = retry_after


class RateLimited(RuntimeError):
    """Admission rejected: the tenant's token bucket is empty.

    ``retry_after`` is exact (seconds until the bucket refills one token),
    not an estimate — clients that sleep it and resubmit are admitted.
    """

    def __init__(self, message: str, *, tenant: str, retry_after: float,
                 rate: float, burst: int) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.retry_after = retry_after
        self.rate = rate
        self.burst = burst


class EnergyBudgetExceeded(RuntimeError):
    """Admission rejected: the tenant's joule budget cannot cover the
    request's predicted energy.

    ``retry_after`` is exact (seconds until the budget refills enough to
    admit this request), ``needed_joules`` is what the request was
    priced at, ``rate``/``burst`` echo the budget knobs.
    """

    def __init__(self, message: str, *, tenant: str, retry_after: float,
                 needed_joules: float, rate: float, burst: float) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.retry_after = retry_after
        self.needed_joules = needed_joules
        self.rate = rate
        self.burst = burst


class RequestTooLarge(RuntimeError):
    """Admission rejected: the request's working set exceeds the per-device
    budget and this service has no distributed paradigm to shard it."""

    def __init__(self, message: str, *, tenant: str, n_points: int) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.n_points = n_points


class RequestDropped(RuntimeError):
    """The request never reached dispatch: the service stopped, or the
    request's deadline expired while it was still queued.

    ``resubmit`` marks drops caused by service shutdown/preemption rather
    than by the request itself (deadline, cancel): those keep their WAL
    entry alive, so :meth:`ClusteringService.recover` replays them after
    restart instead of asking the caller to resend.
    """

    def __init__(self, message: str, *, resubmit: bool = False) -> None:
        super().__init__(message)
        self.resubmit = resubmit


class RequestCancelled(RuntimeError):
    """The request was cancelled through its handle before dispatch."""


class JobSuspended(RuntimeError):
    """The batch holding this request was preempted mid-flight; it is
    checkpointed under ``job_id`` and will be resumed on restart."""

    def __init__(self, job_id: int) -> None:
        super().__init__(
            f"batch job {job_id} suspended; resume_suspended() after restart"
        )
        self.job_id = job_id


def canonical_params(algo: str, params: Dict[str, Any]) -> tuple:
    """Batch-compatibility key view of ``params`` (per-item keys dropped)."""
    return tuple(sorted(
        (k, v) for k, v in params.items() if k not in PER_ITEM_PARAMS
    ))


_REQUEST_IDS = itertools.count(1)


@dataclasses.dataclass
class MiningRequest:
    """One tenant request plus its completion handle."""

    tenant: str
    algo: str                      # "dbscan" | "kmeans"
    data: np.ndarray               # (n, d) float32
    params: Dict[str, Any]         # eps/min_pts or k (+ optional seed, ...)
    executor: Optional[str] = None  # explicit paradigm override
    priority: int = PRIORITY_NORMAL
    deadline: Optional[float] = None   # absolute epoch seconds; None = never
    # expiry bookkeeping on the monotonic clock: set by the service from
    # deadline/ttl at admission, immune to wall-clock steps (NTP, manual
    # set).  The absolute ``deadline`` above stays wall-clock — it is the
    # user-facing API and what the WAL persists across processes.
    deadline_mono: Optional[float] = None
    trace_id: Optional[str] = None  # per-request trace correlation id
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_REQUEST_IDS))
    submitted: float = dataclasses.field(default_factory=time.time)

    # -- filled in as the request moves through the service -----------------
    staged: float = 0.0            # when the micro-batcher staged it
    batched: float = 0.0           # when the micro-batcher claimed it
    completed: float = 0.0
    cache_hit: bool = False
    cache_key: Optional[str] = None
    job_id: Optional[int] = None
    wal_id: Optional[int] = None   # admission-log entry backing this request
    # joules actually charged against the tenant's energy budget at
    # admission — what a cancel/failure refund credits back
    joules_charged: float = 0.0
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _result: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, repr=False)
    _error: Optional[BaseException] = dataclasses.field(
        default=None, repr=False)
    _callbacks: List[Callable[["MiningRequest"], None]] = dataclasses.field(
        default_factory=list, repr=False)
    _state_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    _cancel_requested: bool = dataclasses.field(default=False, repr=False)

    @property
    def n_points(self) -> int:
        return int(self.data.shape[0])

    @property
    def features(self) -> int:
        return int(self.data.shape[1])

    # -- QoS -----------------------------------------------------------------

    def expired(self, now: Optional[float] = None) -> bool:
        # the monotonic deadline governs when set: a wall-clock step must
        # neither expire a fresh request nor immortalise a stale one.
        # Requests built directly with only an absolute deadline (tests,
        # external constructors) keep the legacy wall-clock comparison.
        if self.deadline_mono is not None:
            return time.monotonic() >= self.deadline_mono
        if self.deadline is None:
            return False
        return (time.time() if now is None else now) >= self.deadline

    # -- completion handle ---------------------------------------------------

    def _complete(self, *, result: Optional[Dict[str, Any]] = None,
                  error: Optional[BaseException] = None) -> bool:
        """First completion wins; callbacks run outside the state lock and
        a raising callback cannot strand the other requests of a batch."""
        with self._state_lock:
            if self._done.is_set():
                return False
            self._result = result
            self._error = error
            self.completed = time.time()
            callbacks, self._callbacks = self._callbacks, []
            self._done.set()
        for fn in callbacks:
            self._run_callback(fn)
        return True

    def _run_callback(self, fn: Callable[["MiningRequest"], None]) -> None:
        try:
            fn(self)
        except Exception:
            logger.exception("request %d done-callback raised",
                             self.request_id)

    def resolve(self, result: Dict[str, Any]) -> None:
        self._complete(result=result)

    def fail(self, error: BaseException) -> None:
        self._complete(error=error)

    def claim_for_batch(self, now: float) -> bool:
        """Atomically claim the request for a forming batch; loses to a
        concurrent :meth:`cancel` (the loser drops the request)."""
        with self._state_lock:
            if self._done.is_set() or self._cancel_requested:
                return False
            self.batched = now
            return True

    def cancel(self) -> bool:
        """Best-effort cancel: succeeds only before the batcher claims the
        request (a batched request is already riding a durable job)."""
        with self._state_lock:
            if self.batched or self._done.is_set() or self._cancel_requested:
                return False
            self._cancel_requested = True
        self.fail(RequestCancelled(
            f"request {self.request_id} cancelled before dispatch"))
        return True

    def add_done_callback(self, fn: Callable[["MiningRequest"], None]) -> None:
        """Run ``fn(request)`` on completion (immediately if already done).

        Callbacks fire on the thread that completes the request; keep them
        short and never block on the service from inside one.  A raising
        callback is logged and isolated, never propagated.
        """
        with self._state_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not complete after {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def exception(self,
                  timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not complete after {timeout}s")
        return self._error

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-complete seconds (None while in flight)."""
        if not self._done.is_set():
            return None
        return self.completed - self.submitted

    @property
    def queue_wait(self) -> Optional[float]:
        if self.batched == 0.0:
            return None
        return self.batched - self.submitted


def validate_request(req: MiningRequest) -> None:
    if req.algo not in ALGORITHMS:
        raise ValueError(f"unknown algo {req.algo!r}; want one of {ALGORITHMS}")
    data = np.asarray(req.data)
    if data.ndim != 2 or data.shape[0] < 1 or data.shape[1] < 1:
        raise ValueError(f"data must be (n, d) with n,d >= 1, got {data.shape}")
    if req.algo == "kmeans":
        k = req.params.get("k")
        if not isinstance(k, int) or k < 1:
            raise ValueError("kmeans request needs integer param 'k' >= 1")
        if k > data.shape[0]:
            raise ValueError(f"k={k} exceeds n={data.shape[0]} points")
    else:
        eps = req.params.get("eps")
        min_pts = req.params.get("min_pts")
        if eps is None or min_pts is None:
            raise ValueError("dbscan request needs params 'eps' and 'min_pts'"
                             " (use DBSCANConfig.paper_defaults to derive)")
        if float(eps) <= 0 or int(min_pts) < 1:
            raise ValueError(f"bad dbscan params eps={eps} min_pts={min_pts}")


class AdmissionQueue:
    """Bounded, priority-laned, tenant-fair FIFO-of-FIFOs (thread-safe)."""

    def __init__(self, max_backlog: int = 256,
                 max_per_tenant: int = 64,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: int = 8,
                 tenant_joule_rate: Optional[float] = None,
                 tenant_joule_burst: float = 50.0,
                 joule_cost: Optional[
                     Callable[["MiningRequest"], float]] = None,
                 too_large: Optional[
                     Callable[["MiningRequest"], bool]] = None) -> None:
        self.max_backlog = max_backlog
        self.max_per_tenant = max_per_tenant
        self.tenant_rate = tenant_rate      # tokens/s; None = unlimited
        self.tenant_burst = max(1, tenant_burst)
        # joules/s refill per tenant; None disables the energy budget.
        # ``joule_cost`` prices one request in predicted joules (set by
        # the owning service to its device-class cost model).
        self.tenant_joule_rate = tenant_joule_rate
        self.tenant_joule_burst = float(tenant_joule_burst)
        self.joule_cost = joule_cost
        self.too_large = too_large
        # tenant -> [tokens, last_refill_time]
        self._buckets: Dict[str, List[float]] = {}
        # tenant -> [joules, last_refill_time] (the energy budget twin)
        self._joule_buckets: Dict[str, List[float]] = {}
        self.rate_limited = 0
        self.energy_rejected = 0
        self.energy_refunds = 0
        self.refunded_joules = 0.0
        self.too_large_rejected = 0
        self._lock = threading.Lock()
        # priority -> (OrderedDict keeps a stable tenant rotation order:
        # insertion order, rotated on every drain so no tenant is
        # permanently first within its lane).
        self._lanes: Dict[int, "OrderedDict[str, Deque[MiningRequest]]"] = {}
        self._tenant_depth: Dict[str, int] = {}
        self._depth = 0
        self.rejected = 0
        self.expired = 0
        # drain-rate EWMA feeding the retry_after estimate
        self._drained_at: Optional[float] = None
        self._drain_rate: float = 0.0      # requests/s, 0 = unknown yet
        # telemetry tap: called as on_event(name, fields) for rejections
        # and expiries (never under the queue lock, never raising through)
        self.on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None

    def _notify(self, name: str, **fields: Any) -> None:
        cb = self.on_event
        if cb is None:
            return
        try:
            cb(name, fields)
        except Exception:
            logger.exception("queue on_event hook raised for %s", name)

    # -- retry_after ---------------------------------------------------------

    def _retry_after(self, depth: int) -> float:
        """Seconds until ``depth`` requests likely drained, from the EWMA
        drain rate; bounded so clients neither spin nor stall."""
        if self._drain_rate > 0:
            est = depth / self._drain_rate
        else:
            est = 0.1
        return float(min(5.0, max(0.01, est)))

    def _note_drained(self, count: int, now: float) -> None:
        # every drain — even an empty one — resets the inter-drain clock:
        # otherwise the first drain after an idle gap divides by the whole
        # quiet spell, craters the EWMA, and retry_after balloons
        prev, self._drained_at = self._drained_at, now
        if count <= 0:
            return
        if prev is not None:
            dt = max(1e-6, now - prev)
            inst = count / dt
            self._drain_rate = (0.8 * self._drain_rate + 0.2 * inst
                                if self._drain_rate > 0 else inst)

    # -- rate limiting -------------------------------------------------------

    def _take_token(self, tenant: str, now: float,
                    take: bool = True) -> None:
        """Refill-and-take under the queue lock; raises when the bucket is
        dry.  The failed attempt does not drain anything, so the
        ``retry_after`` it reports stays exact under hammering.
        ``take=False`` peeks — same rejection, zero state change (the
        service's pre-WAL screen)."""
        assert self.tenant_rate is not None
        bucket = self._buckets.get(tenant)
        if bucket is None:
            if not take:
                return                  # a fresh bucket starts full
            bucket = [float(self.tenant_burst), now]
            self._buckets[tenant] = bucket
        # a backwards wall-clock step (NTP, manual set) must refill zero
        # tokens, not drain them; keep the refill reference at the later
        # time so the rewound span is not re-credited when the clock
        # catches back up
        elapsed = max(0.0, now - bucket[1])
        tokens = min(float(self.tenant_burst),
                     bucket[0] + elapsed * self.tenant_rate)
        if tokens < 1.0:
            if take:
                bucket[0] = tokens
                bucket[1] = max(bucket[1], now)
            self.rate_limited += 1
            retry = (1.0 - tokens) / self.tenant_rate
            raise RateLimited(
                f"tenant {tenant!r} over its rate "
                f"({self.tenant_rate:g}/s, burst {self.tenant_burst}); "
                f"retry in {retry:.3f}s",
                tenant=tenant, retry_after=retry,
                rate=self.tenant_rate, burst=self.tenant_burst)
        if not take:
            return
        bucket[0] = tokens - 1.0
        bucket[1] = max(bucket[1], now)

    def _take_joules(self, tenant: str, cost: float, now: float,
                     take: bool = True) -> None:
        """Joule-budget twin of :meth:`_take_token`: refill at
        ``tenant_joule_rate`` J/s up to ``tenant_joule_burst`` J, then
        charge this request's predicted joules.  A request pricier than
        the whole burst gates on a *full* bucket and borrows the rest
        (the bucket goes negative), so it is throttled hard but never
        starved forever.  ``retry_after`` is exact: seconds until the
        deficit refills.  ``take=False`` peeks (zero state change)."""
        assert self.tenant_joule_rate is not None
        burst = self.tenant_joule_burst
        need = min(float(cost), burst)
        bucket = self._joule_buckets.get(tenant)
        if bucket is None:
            if not take:
                return                  # a fresh budget starts full
            bucket = [burst, now]
            self._joule_buckets[tenant] = bucket
        # same backwards-clock discipline as the rate bucket
        elapsed = max(0.0, now - bucket[1])
        joules = min(burst, bucket[0] + elapsed * self.tenant_joule_rate)
        if joules < need:
            if take:
                bucket[0] = joules
                bucket[1] = max(bucket[1], now)
            self.energy_rejected += 1
            retry = (need - joules) / self.tenant_joule_rate
            raise EnergyBudgetExceeded(
                f"tenant {tenant!r} over its energy budget "
                f"(needs {cost:.3g} J, {self.tenant_joule_rate:g} J/s "
                f"refill, burst {burst:g} J); retry in {retry:.3f}s",
                tenant=tenant, retry_after=retry,
                needed_joules=float(cost),
                rate=self.tenant_joule_rate, burst=burst)
        if not take:
            return
        bucket[0] = joules - float(cost)
        bucket[1] = max(bucket[1], now)

    def _price_joules(self, req: MiningRequest) -> float:
        """Predicted joules for one request (0.0 when unpriceable)."""
        if self.joule_cost is None:
            return 0.0
        try:
            return max(0.0, float(self.joule_cost(req)))
        except Exception:
            logger.exception("joule_cost hook raised; admitting unpriced")
            return 0.0

    def refund_joules(self, tenant: str, joules: float) -> float:
        """Credit unconsumed joules back to a tenant's energy budget.

        The admission charge prices work that a cancel or failure never
        delivered; without a refund the tenant pays full price for
        nothing and a cancelled burst starves its next admissions.  The
        credit is capped at the burst (a budget can never hold more than
        a full bucket) and unwinds debt first — a request that borrowed
        beyond the burst gets its loan forgiven before tokens pile up.
        Returns the joules actually credited.
        """
        joules = float(joules)
        if joules <= 0.0 or self.tenant_joule_rate is None:
            return 0.0
        with self._lock:
            now = time.monotonic()
            bucket = self._joule_buckets.get(tenant)
            if bucket is None:
                # never charged since the bucket was dropped (or the
                # budget was enabled after the charge): nothing to unwind
                return 0.0
            before = bucket[0]
            bucket[0] = min(self.tenant_joule_burst, before + joules)
            bucket[1] = max(bucket[1], now)
            credited = bucket[0] - before
            if credited > 0.0:
                self.energy_refunds += 1
                self.refunded_joules += credited
        return credited

    # -- admission -----------------------------------------------------------

    def _screen(self, req: MiningRequest) -> None:
        """Validation + size checks shared by precheck and submit."""
        validate_request(req)
        if self.too_large is not None and self.too_large(req):
            self.too_large_rejected += 1
            raise RequestTooLarge(
                f"request of {req.n_points} points exceeds the per-device "
                f"memory budget and no distributed paradigm is registered "
                f"to shard it",
                tenant=req.tenant, n_points=req.n_points)

    def _bounds_locked(self, req: MiningRequest) -> None:
        """Backlog-depth checks under the queue lock."""
        tenant_depth = self._tenant_depth.get(req.tenant, 0)
        if self._depth >= self.max_backlog:
            self.rejected += 1
            raise BacklogFull(
                f"global backlog full ({self.max_backlog}); retry later",
                tenant=None, depth=self._depth, limit=self.max_backlog,
                retry_after=self._retry_after(self._depth))
        if tenant_depth >= self.max_per_tenant:
            self.rejected += 1
            raise BacklogFull(
                f"tenant {req.tenant!r} backlog full "
                f"({self.max_per_tenant}); retry later",
                tenant=req.tenant, depth=tenant_depth,
                limit=self.max_per_tenant,
                retry_after=self._retry_after(tenant_depth))

    def precheck(self, req: MiningRequest) -> None:
        """Admission screen with zero state change, for the service to run
        *before* the WAL append: the same structured rejections as
        :meth:`submit`, so a request the door would bounce anyway never
        pays a log fsync (nor grows a segment with an instantly-consumed
        entry).  Best-effort — :meth:`submit` remains authoritative; a
        race that slips past the precheck is still rejected there.
        """
        try:
            self._screen(req)
            cost = self._price_joules(req)
            with self._lock:
                self._bounds_locked(req)
                now = time.monotonic()
                if self.tenant_rate is not None:
                    self._take_token(req.tenant, now, take=False)
                if self.tenant_joule_rate is not None and cost > 0.0:
                    self._take_joules(req.tenant, cost, now, take=False)
        except Exception as e:
            self._notify("rejected", stage="precheck",
                         reason=type(e).__name__, tenant=req.tenant,
                         request_id=req.request_id, trace_id=req.trace_id)
            raise

    def submit(self, req: MiningRequest, *, screened: bool = False) -> None:
        """Admit one request.  ``screened=True`` skips the pure
        validation/size screen when the caller just ran :meth:`precheck`
        on the same (immutable) request — the locked bounds/token checks
        always re-run."""
        try:
            if not screened:
                self._screen(req)
            cost = self._price_joules(req)
            with self._lock:
                self._bounds_locked(req)
                # tokens and joules are taken only once the request will
                # actually be admitted: a BacklogFull rejection must not
                # burn rate budget, and an EnergyBudgetExceeded must not
                # burn a rate token (the client's honoured retry would
                # then bounce twice) — so peek both buckets first, then
                # charge both atomically under the one lock
                now = time.monotonic()
                if self.tenant_rate is not None:
                    self._take_token(req.tenant, now, take=False)
                if self.tenant_joule_rate is not None and cost > 0.0:
                    self._take_joules(req.tenant, cost, now, take=False)
                if self.tenant_rate is not None:
                    self._take_token(req.tenant, now)
                if self.tenant_joule_rate is not None and cost > 0.0:
                    self._take_joules(req.tenant, cost, now)
                    req.joules_charged = cost
                lane = self._lanes.setdefault(req.priority, OrderedDict())
                pending = lane.get(req.tenant)
                if pending is None:
                    pending = deque()
                    lane[req.tenant] = pending
                pending.append(req)
                self._tenant_depth[req.tenant] = (
                    self._tenant_depth.get(req.tenant, 0) + 1)
                self._depth += 1
        except Exception as e:
            self._notify("rejected", stage="submit",
                         reason=type(e).__name__, tenant=req.tenant,
                         request_id=req.request_id, trace_id=req.trace_id)
            raise

    # -- drain ---------------------------------------------------------------

    def _pop_tenant(self, lane: "OrderedDict[str, Deque[MiningRequest]]",
                    tenant: str) -> MiningRequest:
        q = lane[tenant]
        req = q.popleft()
        self._depth -= 1
        left = self._tenant_depth.get(tenant, 1) - 1
        if left <= 0:
            self._tenant_depth.pop(tenant, None)
        else:
            self._tenant_depth[tenant] = left
        if not q:
            del lane[tenant]
        return req

    def drain(self, limit: Optional[int] = None,
              now: Optional[float] = None) -> List[MiningRequest]:
        """Pull up to ``limit`` live requests, strict priority order, one per
        tenant per rotation within a lane.

        Requests whose deadline has passed are dropped here — failed with
        :class:`RequestDropped` and never handed to the batcher — and
        already-completed (cancelled) requests are silently discarded.
        """
        now = time.time() if now is None else now
        out: List[MiningRequest] = []
        dead: List[MiningRequest] = []
        with self._lock:
            for priority in sorted(self._lanes):
                lane = self._lanes[priority]
                while lane and (limit is None or len(out) < limit):
                    for tenant in list(lane.keys()):
                        if tenant not in lane:
                            continue
                        req = self._pop_tenant(lane, tenant)
                        # rotate as we go: each tenant served moves to the
                        # back the moment it is popped, so when ``limit``
                        # cuts a rotation short the next drain resumes with
                        # the tenants this one never reached — under
                        # sustained limit pressure no tenant is
                        # systematically favoured by insertion order
                        if tenant in lane:
                            lane.move_to_end(tenant)
                        if req.done():            # cancelled while queued
                            continue
                        if req.expired(now):
                            self.expired += 1
                            dead.append(req)
                            continue
                        out.append(req)
                        if limit is not None and len(out) >= limit:
                            break
                    else:
                        continue
                    break
            self._note_drained(len(out) + len(dead), now)
        # fail expired requests outside the lock: completion callbacks are
        # user code and must not run under the queue lock
        for req in dead:
            req.fail(RequestDropped(
                f"request {req.request_id} missed its deadline "
                f"({req.deadline:.3f}) while queued; never dispatched"))
            self._notify("expired", tenant=req.tenant,
                         request_id=req.request_id, trace_id=req.trace_id)
        return out

    def depth(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is not None:
                return self._tenant_depth.get(tenant, 0)
            return self._depth

    def __len__(self) -> int:
        return self.depth()
