"""The clustering service engine: submit -> batch -> dispatch -> execute.

Two kinds of threads drive the pipeline.  A *dispatcher* drains the
admission queue through the micro-batcher and assigns each formed batch to
an executor *lane* — one queue + worker per registered paradigm — picking
the least-loaded lane among the cost model's compatible candidates.  Lanes
run independently, so a numpy-mt batch genuinely overlaps a cuda-kernel
batch instead of serialising behind one loop.  The device lanes run on
``device`` (``"cuda"`` unless the caller asks for the CPU; the constructor
raises without a card otherwise).  The cache is consulted at
submit time (hits never enter the queue).  ``stop(preempt=True)`` is the
activity-suspend path: the shared token cancels, in-flight batches
checkpoint and park SUSPENDED, and a later process picks them up with
:meth:`ClusteringService.resume_suspended`.  Any ``stop()`` — graceful or
preempting — fails every still-pending request handle, so a caller blocked
in ``wait()`` never hangs past shutdown.

Most callers should not use this class directly: the front door is
:class:`repro_torch.service.client.MiningClient` (futures, QoS, streaming
sessions).  :meth:`ClusteringService.submit` survives as a deprecated shim
over the same path.
"""

from __future__ import annotations

import copy
import itertools
import json
import logging
import os
import queue as _queue
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.service import faults
from repro_torch.service.batcher import BatchKey, MicroBatch, MicroBatcher
from repro_torch.service.bucketing import BucketPolicy, make_policy
from repro_torch.service.config import ServiceConfig
from repro_torch.service.cache import ResultCache, content_key
from repro_torch.runtime import backend as backend_mod
from repro_torch.service.dispatch import (
    EXECUTOR_CUDA,
    EXECUTOR_DISTRIBUTED,
    EXECUTOR_TORCH_REF,
    ParadigmRegistry,
    _kmeans_config,
    default_registry,
    estimate_work,
)
from repro_torch.service.energy import (PowerCapPacer, classify_work,
                                  device_class_for)
from repro_torch.service.exec_cache import default_exec_cache
from repro_torch.service.executor import BatchExecutor, BatchOutcome
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.queue import (
    PRIORITY_NORMAL,
    AdmissionQueue,
    BacklogFull,
    JobSuspended,
    MiningRequest,
    RateLimited,
    RequestDropped,
)
from repro_torch.service.telemetry import EventLog, SLOEvaluator
from repro_torch.service.trace import RequestTracer, new_trace_id, read_spans
from repro_torch.service.wal import RequestLog

logger = logging.getLogger(__name__)


def _per_request_error(e: BaseException) -> BaseException:
    """A fresh exception object for each request of a failed batch.

    ``wait()`` re-raises the stored error, and every raise rewrites the
    instance's ``__traceback__`` — so handing all N requests the *same*
    object lets concurrent waiters mutate it under each other.  Each
    request gets its own copy, chained to the original (``from``) so the
    real failure site stays in the traceback.
    """
    try:
        clone = copy.copy(e)
    except Exception:
        clone = None
    if clone is None or clone is e:
        clone = RuntimeError(f"batch failed: {e!r}")
    clone.__cause__ = e
    return clone


class ExecutorLane:
    """One paradigm's private batch queue + worker thread + load account.

    The queue is priority-ordered (FIFO within a priority), so an
    interactive batch overtakes bulk batches already staged on the lane —
    admission-queue priority carries all the way to execution.  ``load``
    is the work-estimate sum of queued plus in-flight batches, and
    ``energy_load`` the predicted-joules sum of the same — the pool
    balances on joules first (the paper's energy axis as the placement
    objective), falling back to work on ties.  ``busy_s`` accumulates
    wall-clock execution time, which is what the overlap benchmark
    compares against total wall time to show lanes genuinely run
    concurrently.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        # entries: (priority, seq, batch, est, joules); the shutdown
        # sentinel rides at +inf priority so every real batch drains
        # before the worker exits
        self.batches: "_queue.PriorityQueue[tuple]" = _queue.PriorityQueue()
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self.queued_work = 0.0
        self.inflight_work = 0.0
        self.queued_joules = 0.0
        self.inflight_joules = 0.0
        self.busy_s = 0.0
        self.batches_run = 0
        self.thread: Optional[threading.Thread] = None

    @property
    def load(self) -> float:
        with self._lock:
            return self.queued_work + self.inflight_work

    @property
    def energy_load(self) -> float:
        """Predicted joules queued plus in flight on this lane."""
        with self._lock:
            return self.queued_joules + self.inflight_joules

    def put(self, batch: MicroBatch, est: float,
            joules: float = 0.0) -> None:
        with self._lock:
            self.queued_work += est
            self.queued_joules += joules
        self.batches.put((batch.priority, next(self._seq), batch, est,
                          joules))

    def put_sentinel(self) -> None:
        self.batches.put((float("inf"), next(self._seq), None, 0.0, 0.0))

    def begin(self, est: float, joules: float = 0.0) -> None:
        with self._lock:
            self.queued_work -= est
            self.inflight_work += est
            self.queued_joules -= joules
            self.inflight_joules += joules

    def finish(self, est: float, exec_s: float, ran: bool,
               joules: float = 0.0) -> None:
        with self._lock:
            self.inflight_work -= est
            self.inflight_joules -= joules
            if ran:
                self.busy_s += exec_s
                self.batches_run += 1

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "busy_s": self.busy_s,
                "batches": self.batches_run,
                "queued_work": self.queued_work,
                "inflight_work": self.inflight_work,
                "queued_joules": self.queued_joules,
                "inflight_joules": self.inflight_joules,
            }


class ClusteringService:
    def __init__(
        self,
        workdir: str,
        *,
        max_batch: int = 8,
        max_wait_s: float = 0.02,
        continuous: bool = True,
        join_window_s: Optional[float] = None,
        warm_start: Optional[List[Dict[str, Any]]] = None,
        bucket_policy: "str | BucketPolicy | None" = "adaptive",
        max_backlog: int = 256,
        max_per_tenant: int = 64,
        tenant_rate: Optional[float] = None,
        tenant_burst: int = 8,
        tenant_joule_rate: Optional[float] = None,
        tenant_joule_burst: float = 50.0,
        power_cap_watts: Optional[float] = None,
        power_cap_burst_joules: Optional[float] = None,
        cache_entries: int = 256,
        cache_spill: bool = True,
        cache_ttl_s: Optional[float] = 3600.0,
        max_disk_cache_bytes: Optional[int] = None,
        wal: bool = True,
        wal_segment_bytes: int = 4 << 20,
        registry: Optional[ParadigmRegistry] = None,
        device_budget_bytes: Optional[float] = None,
        heartbeat_timeout: float = 60.0,
        checkpoint_every: int = 8,
        poll_interval: float = 0.002,
        trace_capacity: int = 4096,
        event_log: bool = True,
        event_log_bytes: int = 4 << 20,
        event_log_keep: int = 8,
        slo_latency_s: float = 2.0,
        slo_percentile: float = 99.0,
        slo_error_rate: float = 0.05,
        device: str = "cuda",
    ) -> None:
        # discover the device first: without a card, the default "cuda"
        # raises here, before anything is written under the workdir
        backend_mod.load(device)
        self.device = device
        self.workdir = workdir
        if registry is None:
            registry = default_registry(
                device_budget_bytes=device_budget_bytes, device=device)
        elif device_budget_bytes is not None:
            # a caller-supplied registry may be shared with other services;
            # silently rewriting its budget would change THEIR routing
            raise ValueError(
                "pass device_budget_bytes either to the service (which "
                "builds its own registry) or on the registry you supply, "
                "not both")
        self.registry = registry
        # oversized requests are admitted only when they have a home: a
        # registry without the distributed paradigm bounces them at the
        # door (RequestTooLarge) instead of letting them thrash a device
        can_shard = EXECUTOR_DISTRIBUTED in registry.names()
        self.queue = AdmissionQueue(
            max_backlog=max_backlog,
            max_per_tenant=max_per_tenant,
            tenant_rate=tenant_rate,
            tenant_burst=tenant_burst,
            tenant_joule_rate=tenant_joule_rate,
            tenant_joule_burst=tenant_joule_burst,
            joule_cost=self._predict_joules,
            too_large=None if can_shard else self._req_oversized)
        # service-wide power cap: a shared joule bucket every lane pays
        # before running a batch, so modeled watts stay under the cap
        # (dispatch paces; p50 stretches; batches fill — joules/point
        # usually improves, the paper's speed/energy tradeoff as a knob)
        self.pacer: Optional[PowerCapPacer] = (
            PowerCapPacer(power_cap_watts,
                          burst_joules=power_cap_burst_joules)
            if power_cap_watts is not None else None)
        # batch-shape bucketing: how far each batch pads, and therefore how
        # many distinct prepared steps the step cache holds.  "adaptive" (the
        # default; see docs/bucketing_study.md) behaves exactly like the
        # historical pow2 policy until it has observed enough traffic to
        # fit tighter edges.
        self.bucket_policy: BucketPolicy = make_policy(bucket_policy)
        self.batcher = MicroBatcher(
            self.queue, max_batch=max_batch, max_wait_s=max_wait_s,
            oversized=self._req_oversized if can_shard else None,
            bucket_policy=self.bucket_policy,
            joinable=self._join_open)
        # BatchKey -> count of in-flight continuous batches accepting
        # joiners: the batcher defers forming ripe groups for these keys
        # (bounded by its join_defer_s) so boundaries claim them instead
        self._joinable: Dict[BatchKey, int] = {}
        self.executor = BatchExecutor(
            workdir,
            registry=registry,
            heartbeat_timeout=heartbeat_timeout,
            checkpoint_every=checkpoint_every,
        )
        # continuous (in-flight) batching: device-paradigm batches expose
        # iteration boundaries where finished items retire early and
        # compatible queued requests join the run by filling freed padded
        # slots — the device stays hot between micro-batches instead of
        # paying formation + step-0 overhead per convoy straggler.
        # ``join_window_s`` bounds how long after formation a batch keeps
        # admitting joiners (None = for as long as it runs); ``warm_start``
        # is a list of {algo, k, features, n, [executor]} specs whose steps
        # are prepared and launched once at start() so the first request of
        # each expected shape pays neither the kernel build nor a miss.
        self.continuous = bool(continuous)
        self.join_window_s = join_window_s
        self.warm_start = list(warm_start or [])
        self.exec_cache = default_exec_cache()
        self._started_at: Optional[float] = None
        # cache_spill=False keeps the in-memory cache but skips the
        # per-put npz+fsync (for throughput-sensitive deployments that
        # don't need warm restarts)
        self.cache = ResultCache(
            max_entries=cache_entries,
            spill_dir=(os.path.join(workdir, "cache") if cache_spill
                       else None),
            ttl_s=cache_ttl_s,
            max_disk_bytes=max_disk_cache_bytes)
        # write-ahead admission log: every request is durably recorded
        # before it enters the in-memory queue, and marked consumed once
        # its batch job's step-0 checkpoint exists — "admitted means
        # durable".  wal=False opts out (pure-throughput deployments that
        # accept losing queued requests on a crash).
        self.wal: Optional[RequestLog] = (
            RequestLog(os.path.join(workdir, "wal"),
                       segment_bytes=wal_segment_bytes)
            if wal else None)
        self.executor.on_batch_durable = self._batch_durable
        self.metrics = ServiceMetrics()
        # telemetry: per-request span tracer (bounded ring), durable JSONL
        # event log, and SLO targets.  The tracer's sink fans every
        # completed span into the stage-latency metrics and the event log;
        # the log's flushed lines are what let a trace survive SIGKILL
        # (trace.read_spans merges them across process lifetimes).
        self.events: Optional[EventLog] = (
            EventLog(os.path.join(workdir, "events"),
                     max_bytes=event_log_bytes, keep=event_log_keep)
            if event_log else None)
        self.tracer = RequestTracer(capacity=trace_capacity,
                                    sink=self._trace_sink)
        self.slo = SLOEvaluator(latency_target_s=slo_latency_s,
                                latency_percentile=slo_percentile,
                                error_rate_target=slo_error_rate)
        self.executor.tracer = self.tracer
        self.queue.on_event = self._queue_event
        if self.wal is not None:
            self.wal.on_event = self._telemetry_event
        self.token = CancellationToken()
        self.poll_interval = poll_interval
        self.lanes: Dict[str, ExecutorLane] = {}
        self._inflight: Dict[int, MiningRequest] = {}  # request_id -> req
        self._lock = threading.Lock()
        self._running = False
        self._stopped = False
        self._draining = False
        self._dispatcher: Optional[threading.Thread] = None
        # live-reload state: epoch 0 is the constructor config; every
        # successful apply_config() bumps it (see service/config.py)
        self._config_epoch = 0
        self._config_lock = threading.Lock()

    def _join_open(self, key: BatchKey) -> bool:
        """Batcher hint: is an in-flight continuous batch with this key
        still accepting joiners?"""
        with self._lock:
            return self._joinable.get(key, 0) > 0

    def _req_oversized(self, req: MiningRequest) -> bool:
        """Does one request's working set exceed the per-device budget?

        Judged at the bucket *ceiling* — the largest shape the policy may
        ever pad this request to — not the current bucket: a self-tuning
        policy can re-fit between this screen and batch formation, and a
        request admitted as in-budget must stay in-budget at execution."""
        return self.registry.oversized(
            req.algo, req.n_points, req.features, req.params,
            bucket=self.bucket_policy.bucket_ceiling)

    def _predict_joules(self, req: MiningRequest) -> float:
        """Price one request in predicted joules (the admission budget's
        ``joule_cost`` hook): work estimate at the padded bucket the
        request will execute at, priced at the energy-optimal device
        class — the class dispatch prefers for that work size."""
        n_pad = max(int(self.bucket_policy.bucket(req.n_points)),
                    req.n_points)
        work = estimate_work(req.algo, n_pad, req.features, 1, req.params)
        return classify_work(work).modeled_joules(work)

    def _batch_joules(self, name: str, est: float,
                      hints: Dict[str, float]) -> float:
        """Predicted joules of one batch on one lane: measured EWMA
        joules-per-work when the paradigm has history, else its device
        class's static model."""
        hint = hints.get(name)
        if hint is not None:
            return float(hint) * est
        return device_class_for(name).modeled_joules(est)

    # -- telemetry plumbing --------------------------------------------------

    def _trace_sink(self, event: str, payload: Dict[str, Any]) -> None:
        """Tracer sink: completed spans feed the per-stage latency
        breakdown, and every span/span_start is journaled to the event
        log (the durable half of cross-process trace continuity)."""
        if event == "span":
            attrs = payload.get("attrs") or {}
            self.metrics.record_stage(
                str(payload.get("name")),
                float(payload.get("dur_s") or 0.0),
                executor=attrs.get("executor"))
        if self.events is not None:
            self.events.emit(event, **payload)

    def _queue_event(self, name: str, fields: Dict[str, Any]) -> None:
        """Queue hook: a rejection/expiry with a trace lands on that trace
        as a marker span (the sink then journals it); events for requests
        that never got a trace go straight to the log."""
        tid = fields.get("trace_id")
        if tid:
            self.tracer.mark(
                tid, name,
                **{k: v for k, v in fields.items() if k != "trace_id"})
        elif self.events is not None:
            self.events.emit(name, **fields)

    def _telemetry_event(self, name: str, fields: Dict[str, Any]) -> None:
        """Plain structured-event tap (WAL compactions, batch outcomes)."""
        if self.events is not None:
            self.events.emit(name, **fields)

    def export_trace(self, trace_id: Optional[str] = None
                     ) -> List[Dict[str, Any]]:
        """Span dicts for one trace (or all), merged across process
        lifetimes: the in-memory ring plus every span journaled in the
        event log — a request preempted under a dead process and resumed
        here exports as ONE trace covering both attempts."""
        spans = {s["span_id"]: s for s in self.tracer.export(trace_id)}
        if self.events is not None:
            for d in read_spans(self.events.root, trace_id):
                prior = spans.get(d["span_id"])
                if prior is None or (prior.get("phase") == "start"
                                     and d.get("phase") == "complete"):
                    spans[d["span_id"]] = d
        out = list(spans.values())
        out.sort(key=lambda s: (s.get("t0") or 0.0))
        return out

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ClusteringService":
        if self._running:
            return self
        if self.events is not None:
            # a prior stop() closed the log; keep journaling spans across
            # restart cycles of the same service object
            self.events.reopen()
        self.token.reset()
        self._running = True
        self._stopped = False
        self._draining = False
        self._started_at = time.monotonic()
        try:
            self._warm_exec_cache()
        except BaseException:
            self._running = False
            self._stopped = True
            raise
        self.lanes = {name: ExecutorLane(name)
                      for name in self.registry.names()}
        for lane in self.lanes.values():
            lane.thread = threading.Thread(
                target=self._lane_loop, args=(lane,), daemon=True,
                name=f"clustering-lane-{lane.name}")
            lane.thread.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="clustering-dispatch")
        self._dispatcher.start()
        return self

    def _warm_exec_cache(self) -> None:
        """Prepare and launch once the steps the warm-start specs predict.

        Each spec pins a params class and a representative point count;
        the service's own bucket policy rounds the count to the padded
        shape live traffic would get, so the warmed key matches the key
        the executor will ask for.  A bad spec is logged and skipped —
        except when the kernel lane fails on a CUDA device: then every
        kernel-lane batch would fail later, so :meth:`start` raises now
        instead of starting quietly broken.
        """
        for spec in self.warm_start:
            ex = ""
            dev = None
            try:
                if str(spec.get("algo", "kmeans")) != "kmeans":
                    continue   # only the K-Means step is warmed today
                d = int(spec["features"])
                n = int(spec.get("n", 1024))
                n_pad = max(int(self.bucket_policy.bucket(n)), n)
                params = {k: v for k, v in spec.items()
                          if k not in ("algo", "features", "n", "executor")}
                names = self.registry.names()
                execs = ([str(spec["executor"])] if spec.get("executor")
                         else [x for x in (EXECUTOR_CUDA, EXECUTOR_TORCH_REF)
                               if x in names])
                for ex in execs:
                    dev = getattr(self.registry.get(ex), "device", None)
                    if dev is None:
                        continue   # a host paradigm has no step to warm
                    cfg = _kmeans_config(
                        params, use_kernel=(ex == EXECUTOR_CUDA))
                    self.exec_cache.warm_kmeans(n_pad, d, cfg, dev)
            except Exception:
                if ex == EXECUTOR_CUDA and dev is not None \
                        and dev.type == "cuda":
                    raise
                logger.exception("warm-start spec %r failed", spec)

    def __enter__(self) -> "ClusteringService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, preempt: bool = False, timeout: float = 30.0,
             drain: bool = False) -> None:
        """Graceful stop drains everything staged; ``preempt=True`` is the
        OS-suspend path — in-flight batches checkpoint and SUSPEND.  Either
        way, every request handle still pending when the threads are gone is
        failed, so no caller blocked in ``wait()`` outlives the service.

        ``drain=True`` is the zero-downtime variant (rolling restarts,
        fleet failover): admission closes first (new submits bounce with
        a retryable :class:`BacklogFull` so a router sends them
        elsewhere), then everything already admitted — queued, staged, or
        in flight — runs to completion within ``timeout``, marking its
        WAL entries consumed through the normal durable path.  Only then
        do the threads stop and the WAL lock release, so a successor
        process inherits an (ideally) empty log instead of a replay.
        Whatever misses the deadline falls back to the graceful-stop
        contract: failed with ``resubmit=True``, WAL entry kept live.
        """
        deadline = time.monotonic() + timeout
        if drain and not preempt and self._running:
            with self._lock:
                self._draining = True
            # the dispatcher/lanes are still running: the admission queue
            # empties through normal batching while we wait for the
            # in-flight table (which covers queued AND executing requests)
            # to go quiet
            while time.monotonic() < deadline:
                with self._lock:
                    busy = bool(self._inflight)
                if not busy and len(self.queue) == 0:
                    break
                time.sleep(self.poll_interval * 5)
            # a drain that ate the whole budget still owes the threads a
            # real join window — never hand them join(0)
            deadline = max(deadline, time.monotonic() + 5.0)
        if preempt:
            self.token.cancel(CancelReason.PREEMPTION)
        self._running = False
        with self._lock:
            self._stopped = True
        # join budget on the monotonic clock (shared with the drain wait
        # above): a wall-clock step (NTP, DST) must not stretch or starve
        # the shutdown timeout
        if self._dispatcher is not None:
            self._dispatcher.join(max(0.0, deadline - time.monotonic()))
            self._dispatcher = None
        for lane in self.lanes.values():
            if lane.thread is not None:
                lane.thread.join(max(0.0, deadline - time.monotonic()))
                lane.thread = None
        # anything that slipped into the queue around shutdown would
        # otherwise wait forever — no worker will ever drain it
        self._drop_undurable()
        self._fail_pending()
        if self.wal is not None:
            # release the append fd (a later submit/recover reopens it);
            # a stopped service must not hold a stale handle a successor
            # process's torn-tail truncation could race with
            self.wal.close()
        if self.events is not None:
            self.events.close()

    # -- submission ----------------------------------------------------------

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
    ) -> MiningRequest:
        """Deprecated shim: use :class:`repro_torch.service.client.MiningClient`.

        Kept so pre-pool callers continue to work; returns the raw
        :class:`MiningRequest` whose ``wait()`` is the old blocking API.
        """
        warnings.warn(
            "ClusteringService.submit is deprecated; use "
            "repro_torch.service.MiningClient.submit (returns a ResultHandle)",
            DeprecationWarning, stacklevel=2)
        return self._submit(tenant, algo, data, params=params,
                            executor=executor, priority=priority,
                            deadline=deadline, ttl=ttl)

    def _submit(
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
        trace_id: Optional[str] = None,
    ) -> MiningRequest:
        if self._draining:
            # drain means "finish what you have, accept nothing new" —
            # and the rejection must be RETRYABLE so a fleet router sends
            # the request to another worker instead of failing the caller
            raise BacklogFull(
                "service is draining (rolling restart / failover); "
                "resubmit elsewhere", tenant=tenant,
                depth=len(self.queue), limit=0, retry_after=0.1)
        data = np.ascontiguousarray(np.asarray(data, np.float32))
        now_w = time.time()
        if ttl is not None:
            ttl_deadline = now_w + ttl
            deadline = (ttl_deadline if deadline is None
                        else min(deadline, ttl_deadline))
        # expiry bookkeeping runs on the monotonic clock (immune to NTP
        # steps / wall-clock jumps); the absolute wall-clock ``deadline``
        # remains the API and WAL representation, re-anchored to monotonic
        # here at every (re)submission
        deadline_mono = (time.monotonic() + max(0.0, deadline - now_w)
                         if deadline is not None else None)
        req = MiningRequest(tenant=tenant, algo=algo, data=data,
                            params=dict(params), executor=executor,
                            priority=priority, deadline=deadline,
                            deadline_mono=deadline_mono,
                            trace_id=trace_id or new_trace_id())
        # reject params the batch key cannot hash at the door, not in the
        # worker thread (an unhashable value would kill the service loop)
        try:
            hash(BatchKey.for_request(req))
        except TypeError as e:
            raise ValueError(
                f"params values must be hashable (they form the batch "
                f"compatibility key): {e}") from None
        # the WAL persists params as JSON; a value that does not survive
        # the roundtrip (a tuple comes back as a list, an int key as a
        # str) would be admitted durably but rejected at replay — refuse
        # it synchronously instead of losing it silently after a crash
        if self.wal is not None:
            try:
                roundtrip = json.loads(json.dumps(req.params))
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"params must be JSON-serializable (the durable "
                    f"admission log persists them as JSON): {e}") from None
            if roundtrip != req.params:
                raise ValueError(
                    "params must survive a JSON roundtrip (the durable "
                    "admission log persists them as JSON); use "
                    "lists/scalars instead of tuples or non-string keys")
        req.cache_key = content_key(algo, req.params, data)
        t_c, m_c = time.time(), time.monotonic()
        cached = self.cache.get(req.cache_key)
        self.tracer.emit(req.trace_id, "cache_lookup", t_c,
                         time.monotonic() - m_c, hit=cached is not None)
        if cached is not None:
            req.cache_hit = True
            req.resolve(cached)
            self.metrics.record_request(
                tenant=tenant, algo=algo,
                executor=str(cached.get("executor", "cache")),
                latency_s=req.latency or 0.0, cache_hit=True)
            self.tracer.mark(req.trace_id, "deliver", cache_hit=True)
            return req
        if req.expired():
            self.metrics.record_failure("RequestDropped")
            req.fail(RequestDropped(
                f"request {req.request_id} was already past its deadline "
                f"at submission"))
            return req
        if self.wal is not None:
            # cheap screen before the durable append: a request the door
            # would reject anyway (invalid, backlog full, rate limited)
            # must not pay the WAL fsync — overload shedding stays an
            # in-memory affair.  (Without a WAL there is nothing to save;
            # queue.submit below is the one screen.)
            with self.tracer.begin(req.trace_id, "precheck"):
                self.queue.precheck(req)
            # publish the entry id in the in-flight table BEFORE the
            # bytes can exist on disk: a concurrent recover() filters
            # replays against this table, and an id that became durable
            # before becoming visible would replay as a duplicate
            req.wal_id = self.wal.reserve_id()
            with self._lock:
                self._inflight[req.request_id] = req
            # WAL first, queue second: once the caller is told the request
            # was admitted, its payload is already durable — a crash
            # between here and batch formation is replayed by recover().
            # The append happens outside the service lock (it fsyncs;
            # group commit amortises concurrent submitters onto one sync).
            try:
                with self.tracer.begin(req.trace_id, "wal_append",
                                       entry_id=req.wal_id):
                    self.wal.append_admit(
                        tenant, algo, data, req.params, executor=executor,
                        priority=priority, deadline=deadline,
                        cache_key=req.cache_key, entry_id=req.wal_id,
                        trace_id=req.trace_id)
            except BaseException:
                with self._lock:
                    self._inflight.pop(req.request_id, None)
                raise
        t_e, m_e = time.time(), time.monotonic()
        try:
            with self._lock:
                # check-and-enqueue under the same lock stop() takes before
                # its final drop pass, so no request can slip in behind
                # shutdown
                stopped = self._stopped or self.token.cancelled()
                if stopped:
                    self._inflight.pop(req.request_id, None)
                else:
                    # with a WAL, precheck above already screened and only
                    # the locked bounds/token checks re-run (raises
                    # BacklogFull et al.); without one this is the sole
                    # screen
                    self.queue.submit(req, screened=self.wal is not None)
                    self._inflight[req.request_id] = req
        except BaseException:
            # rejected at the door (BacklogFull/RateLimited/validation):
            # the caller was told "not admitted", so the entry must not
            # replay
            with self._lock:
                self._inflight.pop(req.request_id, None)
            self._wal_consume(req)
            raise
        if stopped:
            # fail + consume outside the lock: both fire user-visible
            # side effects (callbacks, a WAL fsync) no submitter or
            # stop() should serialise behind
            req.fail(RequestDropped(
                "service is stopped/preempted; resubmit after restart"))
            self._wal_consume(req)
            return req
        self.tracer.emit(req.trace_id, "enqueue", t_e,
                         time.monotonic() - m_e,
                         config_epoch=self._config_epoch)
        req.add_done_callback(self._request_done)
        return req

    # -- dispatcher ----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while self._running and not self.token.cancelled():
            try:
                batches = self.batcher.poll()
            except Exception:
                # a poisoned request must not kill the serving loop
                time.sleep(self.poll_interval)
                continue
            if not batches:
                time.sleep(self.poll_interval)
                continue
            for batch in batches:
                self._assign(batch)
        if not self.token.cancelled():
            # graceful stop: drain whatever is staged before exiting
            for batch in self.batcher.flush_all():
                self._assign(batch)
        else:
            self._drop_undurable()
        for lane in self.lanes.values():
            lane.put_sentinel()

    def _assign(self, batch: MicroBatch) -> None:
        """Route a formed batch to the least-loaded compatible lane.

        Costing uses the *padded* shape (the batch's bucket): that is what
        the paradigm prepares and executes, so the lane-load account and
        the plan's own cost estimate price the same work."""
        key = batch.key
        params = key.params_dict
        n_pad = batch.n_max
        hints = self.metrics.energy_hints()
        try:
            # n_pad is the batch's final padded shape (the batcher already
            # applied the policy), so the budget check inside candidates
            # must price it verbatim — identity, not another bucketing pass
            names = self.registry.candidates(
                key.algo, n=n_pad, d=key.features, batch_size=batch.size,
                params=params, explicit=key.executor,
                energy_hints=hints,
                bucket=lambda n: n)
        except Exception as e:
            # unknown executor, poisoned params, a failing cost model —
            # whatever it is, it fails THIS batch's requests; it must
            # never take the dispatcher thread (and the service) down
            for req in batch.requests:
                req.fail(_per_request_error(e))
            return
        est = estimate_work(key.algo, n_pad, key.features, batch.size,
                            params)
        # balance on predicted joules in flight first (each lane's cost
        # for THIS batch included, since the classes price work
        # differently), then raw work as the tie-break — queue depth
        # alone would not see the classes' prices
        lane = min((self.lanes[name] for name in names
                    if name in self.lanes),
                   key=lambda ln: (ln.energy_load
                                   + self._batch_joules(ln.name, est,
                                                        hints),
                                   ln.load),
                   default=None)
        if lane is None:
            for req in batch.requests:
                req.fail(RequestDropped(
                    f"no executor lane available for {names}"))
            return
        now = time.time()
        for req in batch.requests:
            if not req.trace_id:
                continue
            # queue_wait covers submit -> staged (admission queue time);
            # batch_wait covers staged -> claimed (coalescing time)
            staged = req.staged or req.batched or now
            self.tracer.emit(req.trace_id, "queue_wait", req.submitted,
                             max(0.0, staged - req.submitted))
            if req.staged:
                claimed = req.batched or now
                self.tracer.emit(req.trace_id, "batch_wait", req.staged,
                                 max(0.0, claimed - req.staged))
        first = batch.requests[0]
        if first.trace_id:
            self.tracer.mark(
                first.trace_id, "batch_form", batch_id=batch.batch_id,
                size=batch.size, capacity=batch.capacity,
                n_pad=batch.n_max, oversized=batch.oversized,
                lane=lane.name)
        lane.put(batch, est, self._batch_joules(lane.name, est, hints))

    # -- lane workers --------------------------------------------------------

    def _lane_loop(self, lane: ExecutorLane) -> None:
        while True:
            _prio, _seq, batch, est, joules = lane.batches.get()
            if batch is None:
                return
            lane.begin(est, joules)
            ran = False
            t0 = time.monotonic()
            try:
                if self.token.cancelled():
                    # preempted before this batch became durable (no job
                    # was formed): the requests must be resubmitted
                    for req in batch.requests:
                        req.fail(RequestDropped(
                            f"request {req.request_id} was queued on lane "
                            f"{lane.name} when the service was preempted; "
                            f"recover() will replay it", resubmit=True))
                    continue
                if self.pacer is not None:
                    # the --power-cap gate: pay this batch's predicted
                    # joules into the shared bucket before dispatching —
                    # blocks while the service is over cap, trading p50
                    # for modeled watts <= cap.  Shutdown aborts the wait
                    # (the batch then runs or is failed by stop()).
                    waited = self.pacer.acquire(
                        joules, abort=lambda: (not self._running
                                               or self.token.cancelled()))
                    if waited > 0 and batch.requests[0].trace_id:
                        self.tracer.mark(batch.requests[0].trace_id,
                                         "power_cap_wait",
                                         lane=lane.name, wait_s=waited)
                ran = True
                self._run_batch(batch, lane.name)
            finally:
                lane.finish(est, time.monotonic() - t0, ran, joules)

    def _run_batch(self, batch: MicroBatch, executor: str) -> None:
        now = time.time()
        for req in batch.requests:
            if req.trace_id and req.batched:
                # claimed into a batch -> picked up by a lane worker
                self.tracer.emit(req.trace_id, "lane_wait", req.batched,
                                 max(0.0, now - req.batched),
                                 executor=executor)
        # continuous batching rides the device paradigms only: their host
        # loops expose iteration boundaries; numpy-mt runs items to
        # completion on a pool and distributed batches are singletons
        use_cont = (self.continuous and not batch.oversized
                    and executor in (EXECUTOR_CUDA, EXECUTOR_TORCH_REF))
        joined_reqs: List[MiningRequest] = []
        join_source = on_retire = None
        unregister = lambda: None  # noqa: E731 - rebound when use_cont
        if use_cont:
            formed = time.monotonic()
            with self._lock:
                self._joinable[batch.key] = \
                    self._joinable.get(batch.key, 0) + 1
            registered = [True]

            def unregister() -> None:
                if not registered[0]:
                    return
                registered[0] = False
                with self._lock:
                    left = self._joinable.get(batch.key, 0) - 1
                    if left > 0:
                        self._joinable[batch.key] = left
                    else:
                        self._joinable.pop(batch.key, None)

            def join_source(limit: int) -> List[MiningRequest]:
                if (not self._running or self._draining
                        or self.token.cancelled()):
                    unregister()
                    return []
                if (self.join_window_s is not None
                        and time.monotonic() - formed > self.join_window_s):
                    unregister()   # window closed: stop deferring staging
                    return []
                got = self.batcher.take_joinable(
                    batch.key, batch.n_max, limit)
                joined_reqs.extend(got)
                return got

            def on_retire(req: MiningRequest, result: Dict[str, Any]) -> None:
                # the early-retirement delivery path: fires mid-batch from
                # the executor the moment an item's labels exist
                t_d, m_d = time.time(), time.monotonic()
                if req.cache_key:
                    self.cache.put(req.cache_key, result)
                req.resolve(result)
                if req.trace_id:
                    self.tracer.emit(req.trace_id, "deliver", t_d,
                                     time.monotonic() - m_d,
                                     executor=executor)
                self.metrics.record_request(
                    tenant=req.tenant, algo=req.algo, executor=executor,
                    latency_s=req.latency or 0.0,
                    queue_wait_s=req.queue_wait or 0.0)

        try:
            outcome = self.executor.run_batch(
                batch, token=self.token, executor=executor,
                energy_hints=self.metrics.energy_hints(),
                continuous=use_cont, join_source=join_source,
                on_retire=on_retire)
        except BaseException as e:
            # each request gets its own exception object: concurrent
            # wait() callers re-raise, and a raise mutates the instance's
            # __traceback__ — sharing one across threads races
            for req in batch.requests + joined_reqs:
                if not req.done():
                    req.fail(_per_request_error(e))
            return
        finally:
            unregister()
        try:
            self._absorb(batch.requests + joined_reqs, outcome)
        except BaseException as e:
            # absorption (metrics, cache, resolve) must never kill the
            # lane worker: fail whatever did not resolve and keep serving
            for req in batch.requests + joined_reqs:
                if not req.done():
                    req.fail(_per_request_error(e))

    @staticmethod
    def _ewma_work(outcome: BatchOutcome) -> float:
        """Plan cost for the energy EWMA — only when exec_s covers the
        whole batch.  A suspended or resumed batch pairs the *full* cost
        with *partial* execution time; feeding that in would bias the
        joules-per-work estimate low for whichever paradigm gets
        preempted most often."""
        if outcome.suspended or outcome.resumed:
            return 0.0
        return float((outcome.plan or {}).get("cost", 0.0))

    def _absorb(self, requests: List[MiningRequest],
                outcome: BatchOutcome) -> None:
        self.metrics.record_batch(
            algo=outcome.algo, executor=outcome.executor, size=outcome.size,
            capacity=outcome.capacity, n_max=outcome.n_max,
            exec_s=outcome.exec_s, resumed=outcome.resumed,
            work=self._ewma_work(outcome),
            real_points=outcome.real_points,
            features=int((outcome.plan or {}).get("features", 0)),
            host_s=outcome.host_s, device_s=outcome.device_s,
            device_class=str((outcome.plan or {}).get("device_class", "")))
        self._telemetry_event("batch", {
            "job_id": outcome.job_id, "algo": outcome.algo,
            "executor": outcome.executor, "size": outcome.size,
            "exec_s": outcome.exec_s, "host_s": outcome.host_s,
            "device_s": outcome.device_s, "suspended": outcome.suspended,
            "resumed": outcome.resumed})
        if outcome.continuous:
            self.metrics.record_continuous(
                joins=outcome.joined, early_retires=outcome.retired,
                slot_occupancy=outcome.size / max(1, outcome.capacity))
        if outcome.suspended:
            self.metrics.record_suspended()
            for req in requests:
                if not req.done():
                    req.fail(JobSuspended(outcome.job_id))
            return
        assert outcome.results is not None
        if outcome.continuous:
            # everything already retired (resolved) mid-batch; this is the
            # backstop for anything the retire path missed
            by_id = {rid: res for rid, res in
                     zip(outcome.request_ids, outcome.results)}
            pending = [(req, by_id.get(req.request_id))
                       for req in requests if not req.done()]
        else:
            pending = list(zip(requests, outcome.results))
        for req, result in pending:
            if result is None:
                req.fail(_per_request_error(RuntimeError(
                    f"request {req.request_id} missing from batch "
                    f"{outcome.job_id} results")))
                continue
            t_d, m_d = time.time(), time.monotonic()
            if req.cache_key:
                self.cache.put(req.cache_key, result)
            req.resolve(result)
            if req.trace_id:
                self.tracer.emit(req.trace_id, "deliver", t_d,
                                 time.monotonic() - m_d,
                                 executor=outcome.executor)
            self.metrics.record_request(
                tenant=req.tenant, algo=req.algo, executor=outcome.executor,
                latency_s=req.latency or 0.0,
                queue_wait_s=req.queue_wait or 0.0)

    # -- WAL bookkeeping -----------------------------------------------------

    def _wal_consume(self, req: MiningRequest,
                     job_id: Optional[int] = None) -> None:
        """Best-effort consume of one request's WAL entry (idempotent)."""
        if self.wal is None or req.wal_id is None:
            return
        try:
            self.wal.mark_consumed([req.wal_id], job_id=job_id)
        except Exception:
            logger.exception("wal consume failed for request %d",
                             req.request_id)

    def _batch_durable(self, job_id: int,
                       requests: List[MiningRequest]) -> None:
        """Executor hook: the batch's step-0 checkpoint exists, so the job
        record now carries durability — the admission-log entries are done."""
        if self.wal is None:
            return
        ids = [r.wal_id for r in requests if r.wal_id is not None]
        if not ids:
            return
        try:
            self.wal.mark_consumed(ids, job_id=job_id)
        except Exception:
            logger.exception("wal consume failed for job %d", job_id)

    def _request_done(self, req: MiningRequest) -> None:
        with self._lock:
            self._inflight.pop(req.request_id, None)
        err = req.exception(timeout=0)
        if err is not None:
            self.metrics.record_failure(type(err).__name__)
            # the admission charge priced work this request never
            # delivered — credit it back so a cancelled/failed burst
            # doesn't starve the tenant's next admissions.  Replayable
            # drops (resubmit=True) refund too: their replay re-charges
            # at resubmission, so keeping the charge would double-bill.
            if req.joules_charged > 0.0:
                self.queue.refund_joules(req.tenant, req.joules_charged)
                req.joules_charged = 0.0
        if self.wal is None or req.wal_id is None:
            return
        if err is not None and getattr(err, "resubmit", False):
            # dropped by shutdown/preemption, not by the request itself:
            # the entry stays live so recover() replays it after restart
            return
        # resolved, cancelled, expired, or failed terminally — no replay
        # wanted.  For batch-completed requests this is a no-op (consumed
        # at step-0 already).
        self._wal_consume(req, job_id=req.job_id)

    def _drop_undurable(self) -> None:
        """Preempted before batching: fail the handles (they die with this
        process) — but their WAL entries stay live, so recover() replays
        them after restart instead of losing them."""
        for batch in self.batcher.flush_all():
            for req in batch.requests:
                req.fail(RequestDropped(
                    f"request {req.request_id} was still queued when the "
                    f"service was preempted; recover() will replay it",
                    resubmit=True))

    def _fail_pending(self) -> None:
        """Shutdown backstop: no handle may dangle after stop() returns.

        Anything still tracked — queued behind a dead dispatcher, staged in
        a lane a worker never drained — is failed so ``wait()`` (with or
        without a timeout) raises instead of blocking forever.
        """
        with self._lock:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
        for req in leftovers:
            if not req.done():
                req.fail(RequestDropped(
                    f"request {req.request_id} was still pending when the "
                    f"service stopped; recover() will replay it",
                    resubmit=True))

    # -- restart path --------------------------------------------------------

    def resume_suspended(self) -> List[BatchOutcome]:
        """Reattach: complete batches suspended by a previous process.

        Results are returned (and re-cached) rather than delivered to
        request handles — the handles died with the old process.
        """
        outcomes = self.executor.resume_suspended(token=self.token)
        for outcome in outcomes:
            self.metrics.record_batch(
                algo=outcome.algo, executor=outcome.executor,
                size=outcome.size, capacity=outcome.capacity,
                n_max=outcome.n_max, exec_s=outcome.exec_s, resumed=True,
                work=self._ewma_work(outcome),
                real_points=outcome.real_points,
                features=int((outcome.plan or {}).get("features", 0)),
                host_s=outcome.host_s, device_s=outcome.device_s,
                device_class=str((outcome.plan or {}).get("device_class",
                                                          "")))
            self._telemetry_event("batch", {
                "job_id": outcome.job_id, "algo": outcome.algo,
                "executor": outcome.executor, "size": outcome.size,
                "exec_s": outcome.exec_s, "host_s": outcome.host_s,
                "device_s": outcome.device_s,
                "suspended": outcome.suspended, "resumed": True})
            if outcome.results and outcome.cache_keys:
                for ckey, result in zip(outcome.cache_keys, outcome.results):
                    if ckey:
                        self.cache.put(ckey, result)
        return outcomes

    def _replay_records(self, records, consume_log, *,
                        replay_rate: Optional[float] = None,
                        replay_burst: int = 8,
                        skip_ids: "frozenset[int] | set" = frozenset(),
                        ) -> Dict[str, Any]:
        """Resubmit WAL records through the front door; the shared engine
        of :meth:`recover` (own log) and :meth:`replay_foreign` (a dead
        peer's log).  Entries are marked consumed in ``consume_log`` only
        after their resubmission is durable under a fresh entry, so a
        crash mid-replay at worst replays twice, never zero times.

        ``replay_rate`` throttles resubmission through a token bucket
        (``replay_burst`` capacity, ``replay_rate`` tokens/s): a failover
        storm re-enters admission smoothly instead of instantly tripping
        ``BacklogFull`` for live traffic.  None = unthrottled.
        """
        handles: List[MiningRequest] = []
        replayed = cache_hits = rejected = 0
        # old entries are consumed in chunks AFTER their resubmissions
        # are durable under fresh entries: per-entry consumes would
        # pay a serial fsync each (2N syncs for N replays); chunking
        # keeps recovery ~N syncs at the cost of a bounded
        # at-least-once window if recovery itself crashes mid-chunk
        done_ids: List[int] = []

        def flush_consumed(force: bool = False) -> None:
            if done_ids and (force or len(done_ids) >= 32):
                consume_log.mark_consumed(done_ids)
                done_ids.clear()

        burst = float(max(1, replay_burst))
        tokens, refilled = burst, time.monotonic()
        for rec in records:
            if rec.entry_id in skip_ids:
                continue
            if replay_rate is not None and replay_rate > 0:
                now = time.monotonic()
                tokens = min(burst, tokens + (now - refilled) * replay_rate)
                refilled = now
                if tokens < 1.0:
                    time.sleep((1.0 - tokens) / replay_rate)
                    tokens, refilled = 1.0, time.monotonic()
                tokens -= 1.0
            try:
                # the replay continues the ORIGINAL trace: one trace id
                # spans both process lifetimes (submit in the dead
                # process, replay + execution here)
                req = self._submit(
                    rec.tenant, rec.algo, rec.data, params=rec.params,
                    executor=rec.executor, priority=rec.priority,
                    deadline=rec.deadline, trace_id=rec.trace_id)
            except (BacklogFull, RateLimited):
                # transient door pressure: keep the entry live — a
                # later recover() re-offers it instead of losing it
                rejected += 1
                continue
            except Exception:
                # poisoned entry (validation/too-large): replaying it
                # again can never succeed, so consume it
                rejected += 1
                done_ids.append(rec.entry_id)
            else:
                replayed += 1
                if req.cache_hit:
                    cache_hits += 1
                if req.trace_id:
                    self.tracer.mark(req.trace_id, "wal_replay",
                                     entry_id=rec.entry_id)
                handles.append(req)
                done_ids.append(rec.entry_id)
            flush_consumed()
        flush_consumed(force=True)
        return {
            "requests": handles,
            "replayed": replayed,
            "cache_hits": cache_hits,
            "rejected": rejected,
        }

    def recover(self, *, replay_rate: Optional[float] = None,
                replay_burst: int = 8) -> Dict[str, Any]:
        """Full restart path: resume suspended batches, then replay every
        admitted-but-unbatched request from the write-ahead admission log.

        Call on a **started** service over the dead process's workdir.
        First :meth:`resume_suspended` completes batches that were already
        durable as jobs; then each unconsumed WAL entry is resubmitted
        through the normal front door — a replay whose content hash is
        already in the result cache (the work completed before the crash,
        or an earlier replay finished it) resolves instantly without
        touching a device.  The old entry is marked consumed only after
        the resubmission is durable under a fresh entry, so a crash
        *during* recovery at worst replays twice, never zero times.

        ``replay_rate`` (requests/s, with a ``replay_burst`` token
        bucket) shapes the replay so a recovery storm shares admission
        smoothly with live traffic instead of tripping ``BacklogFull``.

        Returns a summary: ``outcomes`` (resumed batch results),
        ``requests`` (handles for the replayed submissions — wait on them
        to drive the replay to completion), and counters
        (``resumed_batches`` / ``replayed`` / ``cache_hits`` /
        ``rejected``).  A replay bounced by *transient* door pressure
        (``BacklogFull``/``RateLimited``) keeps its entry live for a
        later ``recover()``; only poisoned entries that can never admit
        are consumed on rejection.
        """
        outcomes = self.resume_suspended()
        summary: Dict[str, Any] = {
            "requests": [], "replayed": 0, "cache_hits": 0, "rejected": 0}
        if self.wal is not None:
            records = self.wal.replay()
            # entries backing requests still alive in THIS process must
            # not replay — they are already queued/staged here, and a
            # second submission would run them twice.  The snapshot is
            # taken AFTER the log read: ids are published to _inflight
            # before their bytes can exist on disk (_submit reserves
            # first), so any entry replay() saw is already visible here.
            with self._lock:
                inflight_ids = {r.wal_id for r in self._inflight.values()
                                if r.wal_id is not None}
            summary = self._replay_records(
                records, self.wal, replay_rate=replay_rate,
                replay_burst=replay_burst, skip_ids=inflight_ids)
            self.wal.compact()
        summary["outcomes"] = outcomes
        summary["resumed_batches"] = len(outcomes)
        return summary

    def replay_foreign(self, wal_root: str, *,
                       replay_rate: Optional[float] = None,
                       replay_burst: int = 8,
                       ) -> Dict[str, Any]:
        """Failover takeover: adopt a dead peer's admission log.

        Opens the WAL at ``wal_root`` — taking its cross-process writer
        lock, so this raises :class:`~repro_torch.service.wal.WalLocked` while
        the owning process is still alive (takeover is only possible
        once the victim is actually dead) — and replays every unconsumed
        admit through THIS service's front door.  Each entry becomes
        durable under a fresh entry in *our* WAL before the old one is
        marked consumed in the victim's log, so the fleet-level
        "admitted means durable" guarantee holds across the handover:
        a crash mid-takeover leaves the remaining entries live for the
        next survivor.  The victim's log is compacted and closed (lock
        released) before returning.

        Returns the replay summary plus ``pending_after`` — entries
        still live in the victim's log (transiently rejected replays a
        later takeover must re-offer).
        """
        foreign = RequestLog(wal_root)
        try:
            records = foreign.replay()
            summary = self._replay_records(
                records, foreign, replay_rate=replay_rate,
                replay_burst=replay_burst)
            foreign.compact()
            summary["pending_after"] = foreign.pending()
        finally:
            foreign.close()
        summary["wal_root"] = wal_root
        self._telemetry_event("wal_takeover", {
            "wal_root": wal_root, "replayed": summary["replayed"],
            "cache_hits": summary["cache_hits"],
            "rejected": summary["rejected"],
            "pending_after": summary["pending_after"]})
        return summary

    # -- zero-downtime operations: live reload + handover ---------------------

    @property
    def config_epoch(self) -> int:
        return self._config_epoch

    def current_config(self) -> ServiceConfig:
        """The live values of every reloadable knob, at the current epoch."""
        return ServiceConfig.from_service(self, epoch=self._config_epoch)

    def apply_config(self, changes: Dict[str, Any]) -> ServiceConfig:
        """Live-reload tuning knobs without a restart.

        Validation-before-apply: the whole candidate config (current
        values + ``changes``) is checked first — including structural
        limits like "a pacer cannot be conjured at runtime" — and only
        then are the live objects mutated, so a rejected reload changes
        *nothing*.  Returns the new config (its ``epoch`` is the proof
        of application; workers report it in ``/healthz``).
        """
        with self._config_lock:
            current = self.current_config()
            candidate = current.replace(dict(changes))
            candidate.validate()
            # structural checks the dataclass cannot know: the pacer's
            # existence is decided at construction (lanes hold the
            # reference), so a cap can be re-tuned live but not toggled
            if candidate.power_cap_watts is not None and self.pacer is None:
                raise ValueError(
                    "enabling a power cap requires a restart: the service "
                    "was built without a pacer (--power-cap at startup)")
            if candidate.power_cap_watts is None and self.pacer is not None:
                raise ValueError(
                    "disabling the power cap requires a restart; raise "
                    "power_cap_watts instead to loosen it")
            new_policy: Optional[BucketPolicy] = None
            if (candidate.bucket_policy is not None
                    and candidate.bucket_policy != current.bucket_policy):
                new_policy = make_policy(candidate.bucket_policy)
            # -- apply: nothing below may fail ---------------------------
            q = self.queue
            q.tenant_rate = candidate.tenant_rate
            q.tenant_burst = candidate.tenant_burst
            q.tenant_joule_rate = candidate.tenant_joule_rate
            q.tenant_joule_burst = float(candidate.tenant_joule_burst)
            q.max_backlog = candidate.max_backlog
            q.max_per_tenant = candidate.max_per_tenant
            if self.pacer is not None and candidate.power_cap_watts:
                with self.pacer._lock:
                    self.pacer.watts = float(candidate.power_cap_watts)
                    if candidate.power_cap_burst_joules is not None:
                        self.pacer.burst_joules = float(
                            candidate.power_cap_burst_joules)
            if new_policy is not None:
                # the batcher shares the policy reference; swap both so
                # future batches bucket under the new edges (in-flight
                # batches keep the shape they were formed at)
                self.bucket_policy = new_policy
                self.batcher.policy = new_policy
            self.join_window_s = candidate.join_window_s
            self._config_epoch = candidate.epoch
        self._telemetry_event("config_reload", {
            "epoch": candidate.epoch,
            "changes": sorted(changes)})
        return candidate

    def handover(self, *, successor_kwargs: Optional[Dict[str, Any]] = None,
                 drain_timeout: float = 30.0,
                 replay_rate: Optional[float] = None,
                 replay_burst: int = 8) -> "ClusteringService":
        """In-process rolling restart: drain, hand the WAL to a successor.

        The predecessor ``stop(drain=True)``s — admission closes with a
        *retryable* rejection, everything admitted runs to completion,
        and the WAL writer lock releases with its fd.  The successor is
        then built over the same workdir (``successor_kwargs`` may change
        any constructor knob — this is how restart-only config lands),
        warms its exec cache via ``warm_start`` during ``start()``, takes
        the WAL lock, and replays whatever the drain left behind,
        rate-shaped.  Returns the started, recovered successor; the
        predecessor is fully stopped.

        The fleet version of this — drain/respawn one *process* at a
        time with the router re-pinning around each — is
        ``WorkerManager.rolling_restart()``.
        """
        kwargs = dict(successor_kwargs or {})
        kwargs.setdefault("warm_start", list(self.warm_start))
        kwargs.setdefault("device", self.device)
        self.stop(drain=True, timeout=drain_timeout)
        # crash window: predecessor drained and unlocked, successor not
        # yet alive — the WAL on disk is the whole truth
        faults.at("service.handover.before_successor")
        successor = ClusteringService(self.workdir, **kwargs)
        successor.start()
        summary = successor.recover(replay_rate=replay_rate,
                                    replay_burst=replay_burst)
        successor._telemetry_event("handover", {
            "predecessor_pid": os.getpid(),
            "replayed": summary["replayed"],
            "resumed_batches": summary["resumed_batches"]})
        return successor

    def metrics_snapshot(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        # the metrics object counts padding/recompiles; the policy itself
        # carries the edges/refit state — one block tells the whole
        # bucketing story (see docs/OPERATIONS.md for the field glossary)
        snap["bucketing"]["policy"] = self.bucket_policy.snapshot()
        snap["cache"] = self.cache.stats()
        snap["queue_depth"] = len(self.queue)
        snap["queue_rejected"] = self.queue.rejected
        snap["queue_expired"] = self.queue.expired
        snap["queue_rate_limited"] = self.queue.rate_limited
        snap["queue_too_large"] = self.queue.too_large_rejected
        snap["lanes"] = {name: lane.stats()
                         for name, lane in self.lanes.items()}
        # continuous-batching scorecard: the metrics object counted
        # joins/retires/occupancy; the service adds its knobs, the
        # executable-cache counters, and per-lane device idle fraction
        # (1 - busy/uptime: the "keep the device hot" number)
        up = (time.monotonic() - self._started_at
              if self._started_at is not None else 0.0)
        snap["continuous"].update({
            "enabled": self.continuous,
            "join_window_s": self.join_window_s,
            "device_idle_frac": {
                name: (max(0.0, 1.0 - lane.stats()["busy_s"] / up)
                       if up > 0 else None)
                for name, lane in self.lanes.items()},
        })
        # energy control surface: the metrics object supplied the modeled
        # watts / per-class / hint views; the service adds its knobs, the
        # power-cap pacer state, the admission-budget counters, and the
        # per-lane predicted-joules loads (see docs/OPERATIONS.md Energy)
        energy = dict(snap.get("energy") or {})
        totals = snap.get("totals") or {}
        real_pts = (snap.get("bucketing") or {}).get("real_points", 0)
        energy.update({
            "power_cap_watts": (self.pacer.watts
                                if self.pacer is not None else None),
            "cap": (self.pacer.snapshot()
                    if self.pacer is not None else None),
            "cap_saturation": (
                min(1.0, energy.get("modeled_watts", 0.0)
                    / self.pacer.watts)
                if self.pacer is not None else 0.0),
            "budget": {
                "tenant_joule_rate": self.queue.tenant_joule_rate,
                "tenant_joule_burst": self.queue.tenant_joule_burst,
                "rejections": self.queue.energy_rejected,
                "refunds": self.queue.energy_refunds,
                "refunded_joules": self.queue.refunded_joules,
            },
            "joules_total": totals.get("modeled_joules", 0.0),
            "joules_per_point": (
                totals.get("modeled_joules", 0.0) / real_pts
                if real_pts else 0.0),
            "lane_joules": {name: {
                "queued": lane.stats()["queued_joules"],
                "inflight": lane.stats()["inflight_joules"]}
                for name, lane in self.lanes.items()},
        })
        snap["energy"] = energy
        snap["exec_cache"] = self.exec_cache.stats()
        snap["wal"] = self.wal.stats() if self.wal is not None else None
        snap["config"] = {"epoch": self._config_epoch,
                          **self.current_config().as_dict()}
        ws = self.metrics.window_stats()
        snap["slo"] = self.slo.evaluate(
            ws["latencies"], ws["failures"], ws["outcomes"])
        snap["trace"] = self.tracer.stats()
        snap["events"] = (self.events.stats()
                          if self.events is not None else None)
        return snap
