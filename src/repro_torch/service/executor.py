"""Durable batch execution: every micro-batch is a resumable job.

The paper's WorkManager contract, per batch: execution is wrapped in a
:class:`repro_torch.core.jobs.JobStore` record, a
:class:`~repro_torch.core.cancellation.CancellationToken` is threaded into the
DBSCAN/K-Means host loops (the abort flag polled between kernel launches),
and partial state — the packed DBSCAN word + BFS frontier, or the K-Means
centroid matrix — is checkpointed through
:class:`repro_torch.checkpoint.store.CheckpointStore`.  A batch killed at any
moment is either SUSPENDED with a verified checkpoint (graceful preemption)
or left RUNNING with a stale heartbeat (hard crash); on restart
:meth:`BatchExecutor.resume_suspended` sweeps both back to completion from
their last checkpoint — the activity-reattach path, now per-request.

Checkpoint layout (one store per batch job, ``<workdir>/ckpt/job_<id>``):
the step-0 checkpoint carries the padded input data, so a restarted process
can rebuild the batch without the original requests in memory; later steps
carry per-item labels plus the mid-item algorithm state.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.cancellation import CancellationToken
from repro_torch.core.jobs import JobState, JobStore
from repro_torch.runtime.preemption import HoldAlive
from repro_torch.service.batcher import MicroBatch
from repro_torch.service.dispatch import (
    ExecutionPlan,
    ItemView,
    ParadigmRegistry,
    default_registry,
    far_diagonal_pad,
)

logger = logging.getLogger(__name__)

SERVICE_JOB_KIND = "service-batch"


@dataclasses.dataclass
class BatchOutcome:
    job_id: int
    algo: str
    executor: str
    suspended: bool
    resumed: bool
    exec_s: float
    size: int
    capacity: int
    n_max: int
    request_ids: List[int]
    tenants: List[str]
    results: Optional[List[Dict[str, Any]]] = None  # per item, when complete
    cache_keys: Optional[List[str]] = None          # per item content hashes
    plan: Optional[Dict[str, Any]] = None           # ExecutionPlan.summary()
    lengths: Optional[List[int]] = None             # per item real points
    host_s: float = 0.0     # exec wall time spent in host bookkeeping
    device_s: float = 0.0   # exec_s minus host_s (the compute share)
    continuous: bool = False  # ran with in-flight join/retire slots
    joined: int = 0           # requests that joined mid-flight
    retired: int = 0          # items delivered before the batch ended

    @property
    def real_points(self) -> int:
        """Sum of real (pre-padding) item lengths — the numerator of the
        batch's point occupancy; ``size * n_max`` is the denominator."""
        return sum(self.lengths or [])


def _pad_item(x: np.ndarray, n_max: int, algo: str, eps: float,
              data_high: float) -> np.ndarray:
    """Pad to the bucket; DBSCAN pads ride the shared far-diagonal scheme
    (see ``dispatch.far_diagonal_pad``; same trick as the block level in
    kernels/neighbor/ops.py)."""
    n, d = x.shape
    out = np.zeros((n_max, d), np.float32)
    out[:n] = x
    if algo == "dbscan" and n < n_max:
        far_diagonal_pad(out, n, eps, data_high)
    return out


class BatchExecutor:
    """Runs micro-batches as durable, preemption-safe jobs."""

    def __init__(
        self,
        workdir: str,
        *,
        registry: Optional[ParadigmRegistry] = None,
        device: str = "cuda",
        heartbeat_timeout: float = 60.0,
        checkpoint_every: int = 8,
        keep_last: int = 2,
        cont_save_interval_s: float = 0.5,
    ) -> None:
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.jobs = JobStore(os.path.join(workdir, "jobs.db"),
                             heartbeat_timeout=heartbeat_timeout)
        # the device paradigms run on "cuda" unless the caller asks for
        # the CPU (a caller-supplied registry carries its own device)
        self.registry = registry or default_registry(device=device)
        self.checkpoint_every = checkpoint_every
        self.keep_last = keep_last
        # continuous batches carry capacity-sized state and fire a slot
        # event per quantum per slot — a full self-contained checkpoint
        # for each would turn the hot loop into an fsync loop.  Writes
        # are coalesced to at most one per this interval; forced writes
        # (first durable step, suspension snapshots) always land.
        self.cont_save_interval_s = cont_save_interval_s
        # fired the moment a batch's step-0 checkpoint exists — the
        # durability hand-off point where the admission WAL releases its
        # entries to the job record (see repro_torch.service.wal)
        self.on_batch_durable: Optional[
            Callable[[int, List[Any]], None]] = None
        # optional RequestTracer (see repro_torch.service.trace): when attached,
        # plan / execute-attempt / checkpoint / resume spans are emitted
        # under each request's trace id — which rides in the job record,
        # so a resumed batch in a NEW process continues the same traces
        self.tracer = None

    def _ckpt(self, job_id: int) -> CheckpointStore:
        return CheckpointStore(
            os.path.join(self.workdir, "ckpt", f"job_{job_id}"),
            keep_last=self.keep_last,
        )

    # -- batch formation -----------------------------------------------------

    def run_batch(
        self,
        batch: MicroBatch,
        token: Optional[CancellationToken] = None,
        progress_hook=None,
        executor: Optional[str] = None,
        energy_hints: Optional[Dict[str, float]] = None,
        continuous: bool = False,
        join_source: Optional[Callable[[int], List[Any]]] = None,
        on_retire: Optional[Callable[[Any, Dict[str, Any]], None]] = None,
    ) -> BatchOutcome:
        """Execute a fresh micro-batch (enqueue -> claim -> run).

        ``executor`` pins the paradigm (the lane pool has already chosen
        one); without it the registry's cost model selects as before.
        ``energy_hints`` (EWMA joules per unit work, per paradigm) make
        the persisted plan's modeled_joules reflect observed behaviour
        instead of the static prior.

        ``continuous`` switches the batch to in-flight (continuous)
        batching: the state tree is sized to the batch *capacity* rather
        than its occupancy, finished items retire the moment they complete
        (``on_retire(request, result)`` fires mid-batch), and at every
        iteration boundary ``join_source(free_slots)`` may hand back
        compatible queued requests that are swapped into freed padded
        slots — same compiled program, no recompilation, the device never
        goes idle between micro-batches.
        """
        key = batch.key
        params = key.params_dict
        if executor is not None:
            self.registry.get(executor)   # validate the pinned lane
        else:
            # the cost model prices the *padded* shape — n_max is what the
            # paradigm will actually compile and execute, not the raw max.
            # It is already the final bucket, so the budget check inside
            # select must take it verbatim (identity), not re-round it up
            # another pow2 window
            executor = self.registry.select(
                key.algo,
                n=batch.n_max,
                d=key.features,
                batch_size=batch.size,
                params=params,
                explicit=key.executor,
                bucket=lambda n: n,
            )
        n_max, d = batch.n_max, key.features
        size = batch.size
        # phase one of the plan/execute contract: placement, shard layout,
        # cost + modeled joules — persisted with the job so the routing
        # decision is inspectable after the fact
        t_plan = time.time()
        m_plan = time.monotonic()
        plan = self.registry.get(executor).plan(
            key.algo, params, batch_size=size, n_max=n_max, features=d,
            energy_hint=(energy_hints or {}).get(executor))
        if self.tracer is not None:
            plan_dur = time.monotonic() - m_plan
            for r in batch.requests:
                if r.trace_id:
                    self.tracer.emit(
                        r.trace_id, "plan", t_plan, plan_dur,
                        executor=executor, batch_id=batch.batch_id)
        eps = float(params.get("eps", 1.0))
        data_high = max(
            float(np.max(r.data)) if r.data.size else 0.0
            for r in batch.requests
        )
        # continuous batches are laid out at CAPACITY, not occupancy: the
        # spare padded slots are what later requests join into
        cont = bool(continuous) and not batch.oversized
        rows = int(batch.capacity) if cont else size

        def _slots(vals: List[Any], fill: Any) -> List[Any]:
            return list(vals) + [fill] * (rows - len(vals))

        job_params = {
            "algo": key.algo,
            "executor": executor,
            "params": params,
            "size": rows,
            "n_max": n_max,
            "features": d,
            "capacity": batch.capacity,
            "continuous": cont,
            "lengths": _slots([r.n_points for r in batch.requests], 0),
            "seeds": _slots(
                [int(r.params.get("seed", 0)) for r in batch.requests], 0),
            "request_ids": _slots(
                [r.request_id for r in batch.requests], -1),
            "tenants": _slots([r.tenant for r in batch.requests], ""),
            # content hashes survive in the job record so a resumed batch
            # can re-populate the result cache after a restart
            "cache_keys": _slots(
                [r.cache_key or "" for r in batch.requests], ""),
            # trace ids survive too: the process that resumes this batch
            # emits its spans under the SAME traces (crash continuity)
            "trace_ids": _slots(
                [r.trace_id or "" for r in batch.requests], ""),
            "plan": plan.summary(),
        }
        job_id = self.jobs.enqueue(SERVICE_JOB_KIND, job_params)
        job = self.jobs.claim(job_id)
        assert job is not None
        for r in batch.requests:
            r.job_id = job_id

        state = self._blank_state(job_params)
        state["occupied"][size:] = False
        for i, r in enumerate(batch.requests):
            state["data"][i] = _pad_item(
                np.asarray(r.data, np.float32), n_max, key.algo, eps,
                data_high)
        ckpt = self._ckpt(job_id)
        # step-0 checkpoint: the batch is durable from this point on
        path = ckpt.save(0, state, metadata={"params": job_params})
        self.jobs.report_progress(job_id, step=0, checkpoint_path=path)
        if self.on_batch_durable is not None:
            # durability has handed over from the admission WAL to the job
            # record; a failing hook must not fail the batch it protects
            try:
                self.on_batch_durable(job_id, batch.requests)
            except Exception:
                logger.exception(
                    "on_batch_durable hook failed for job %d", job_id)
        return self._execute(job_id, job_params, state, token,
                             progress_hook=progress_hook, resumed=False,
                             plan=plan, requests=batch.requests,
                             join_source=join_source if cont else None,
                             on_retire=on_retire)

    # -- state trees ---------------------------------------------------------

    def _blank_state(self, jp: Dict[str, Any]) -> Dict[str, np.ndarray]:
        size, n_max, d = jp["size"], jp["n_max"], jp["features"]
        state: Dict[str, np.ndarray] = {
            "data": np.zeros((size, n_max, d), np.float32),
            "labels": np.zeros((size, n_max), np.int16),
            "done": np.zeros((size,), bool),
            # all-occupied default: only continuous batches carry spare
            # (joinable) slots, and run_batch masks those off explicitly
            "occupied": np.ones((size,), bool),
            "active": np.asarray(False),
            "item": np.int32(0),
            "inertia": np.zeros((size,), np.float32),
            "iterations": np.zeros((size,), np.int32),
            "converged": np.zeros((size,), bool),
            "n_clusters": np.zeros((size,), np.int32),
            "noise": np.zeros((size,), np.int32),
            "expansions": np.zeros((size,), np.int32),
        }
        if jp["algo"] == "dbscan":
            state["mid.packed"] = np.zeros((n_max,), np.int16)
            state["mid.frontier"] = np.zeros((n_max,), bool)
            state["mid.cid"] = np.int32(0)
            state["mid.nexp"] = np.int32(0)
        else:
            k = int(jp["params"]["k"])
            state["mid.centroids"] = np.zeros((k, d), np.float32)
            state["mid.iteration"] = np.int32(0)
            if jp.get("continuous"):
                # continuous K-Means interleaves EVERY slot's Lloyd loop,
                # so mid-flight state is per-slot, not single-cursor
                state["slot.centroids"] = np.zeros((size, k, d), np.float32)
                state["slot.iteration"] = np.zeros((size,), np.int32)
                state["slot.started"] = np.zeros((size,), bool)
        return state

    @staticmethod
    def _mid_tree(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {k[len("mid."):]: v for k, v in state.items()
                if k.startswith("mid.")}

    # -- execution -----------------------------------------------------------

    def _execute(
        self,
        job_id: int,
        jp: Dict[str, Any],
        state: Dict[str, np.ndarray],
        token: Optional[CancellationToken],
        *,
        progress_hook=None,
        resumed: bool,
        plan: Optional[ExecutionPlan] = None,
        requests: Optional[List[Any]] = None,
        join_source: Optional[Callable[[int], List[Any]]] = None,
        on_retire: Optional[Callable[[Any, Dict[str, Any]], None]] = None,
    ) -> BatchOutcome:
        paradigm = self.registry.get(jp["executor"])
        cont = bool(jp.get("continuous"))
        # per-slot mid state (vs the single mid.* cursor): continuous
        # K-Means has every slot mid-flight at once
        cont_slots = cont and jp["algo"] != "dbscan"
        # slot -> live request, for early retirement; popped on delivery so
        # a reused slot can never re-resolve its predecessor
        live: Dict[int, Any] = dict(enumerate(requests or []))
        joined = [0]
        retired = [0]
        if plan is None:
            # resume path: re-plan on THIS host — sharded checkpoints carry
            # gathered, mesh-shape-independent state, so a batch suspended
            # on a 4-shard mesh resumes correctly on 1 (or 8)
            plan = paradigm.plan(
                jp["algo"], jp["params"], batch_size=jp["size"],
                n_max=jp["n_max"], features=jp["features"])
        ckpt = self._ckpt(job_id)
        lock = threading.Lock()
        save_step = [int(ckpt.latest_step() or 0)]
        events = [0]
        tr = self.tracer
        traces: List[str] = [str(t) for t in (jp.get("trace_ids") or [])]
        host = [0.0]   # checkpoint + progress time inside the exec window

        last_write = [0.0, ""]   # monotonic time of last write, its path

        def save(item: Optional[int] = None) -> str:
            # continuous write coalescing: the in-memory state is always
            # current, so skipping a write costs only resume granularity
            # (the WAL keeps every unresolved request replayable).  A
            # cancelled token means suspension snapshots are in flight —
            # those must land before the process exits, so they always
            # write; so does the first step (the durability hand-off).
            if (cont and last_write[1]
                    and (token is None or not token.cancelled())
                    and time.monotonic() - last_write[0]
                    < self.cont_save_interval_s):
                return last_write[1]
            # every checkpoint is self-contained (data rides along), so GC
            # of old steps can never strand a resume
            save_step[0] += 1
            t_wall = time.time()
            m0 = time.monotonic()
            path = ckpt.save(save_step[0], state, metadata={"params": jp})
            last_write[0], last_write[1] = time.monotonic(), path
            self.jobs.report_progress(job_id, step=save_step[0],
                                      checkpoint_path=path)
            dur = time.monotonic() - m0
            host[0] += dur
            if (tr is not None and item is not None
                    and 0 <= item < len(traces) and traces[item]):
                tr.emit(traces[item], "checkpoint", t_wall, dur,
                        executor=jp["executor"], job_id=job_id,
                        step=save_step[0])
            return path

        def on_item_state(i: int, tree: Dict[str, np.ndarray]) -> None:
            with lock:
                if cont_slots:
                    state["slot.centroids"][i] = np.asarray(
                        tree["centroids"], np.float32)
                    state["slot.iteration"][i] = np.int32(tree["iteration"])
                    state["slot.started"][i] = True
                else:
                    state["active"] = np.asarray(True)
                    state["item"] = np.int32(i)
                    for k, v in tree.items():
                        state[f"mid.{k}"] = np.asarray(v)
                save(i)
            events[0] += 1
            if progress_hook is not None:
                progress_hook(job_id, i, events[0])

        def on_item_done(i: int, labels: np.ndarray,
                         scalars: Dict[str, Any]) -> None:
            with lock:
                state["labels"][i] = labels.astype(np.int16)
                state["done"][i] = True
                state["active"] = np.asarray(False)
                state["item"] = np.int32(i + 1)
                if cont_slots:
                    state["slot.started"][i] = False
                for name in ("inertia", "iterations", "converged",
                             "n_clusters", "noise", "expansions"):
                    if name in scalars:
                        state[name][i] = scalars[name]
                save(i)
                result = (self._item_result(jp, state, i)
                          if on_retire is not None else None)
            events[0] += 1
            if progress_hook is not None:
                progress_hook(job_id, i, events[0])
            if on_retire is not None:
                # early retirement: the item's future resolves NOW, not
                # when the whole batch drains (outside the state lock —
                # completion callbacks are arbitrary user code)
                req = live.pop(i, None)
                if req is not None:
                    retired[0] += 1
                    try:
                        on_retire(req, result)
                    except Exception:
                        logger.exception(
                            "on_retire failed for request %s (job %d)",
                            getattr(req, "request_id", "?"), job_id)
                    if (tr is not None and 0 <= i < len(traces)
                            and traces[i]):
                        tr.mark(traces[i], "retire", job_id=job_id, slot=i)

        # remaining items, current (possibly mid-flight) one first
        items: List[ItemView] = []
        active = bool(state["active"])
        current = int(state["item"])
        for i in range(jp["size"]):
            if not bool(state["occupied"][i]) or bool(state["done"][i]):
                continue
            mid = None
            if cont_slots:
                if bool(state["slot.started"][i]):
                    mid = {
                        "centroids": np.array(state["slot.centroids"][i]),
                        "iteration": np.int32(state["slot.iteration"][i]),
                    }
            elif active and i == current and paradigm.resumable_mid_item:
                mid = self._mid_tree(state)
            items.append(ItemView(
                index=i,
                x_pad=np.asarray(state["data"][i]),
                length=int(jp["lengths"][i]),
                seed=int(jp["seeds"][i]),
                mid_state=mid,
            ))

        boundary: Optional[Callable[[], List[ItemView]]] = None
        if cont and join_source is not None:
            eps = float(jp["params"].get("eps", 1.0))

            def boundary() -> List[ItemView]:
                with lock:
                    free = [i for i in range(jp["size"])
                            if not bool(state["occupied"][i])
                            or bool(state["done"][i])]
                if not free:
                    return []
                views: List[ItemView] = []
                for req in join_source(len(free)):
                    slot = free.pop(0)
                    x = np.asarray(req.data, np.float32)
                    high = float(np.max(x)) if x.size else 0.0
                    padded = _pad_item(x, int(jp["n_max"]), jp["algo"], eps,
                                       high)
                    with lock:
                        # host-side slot swap — the prepared step never
                        # sees a new shape, only new bytes in an old slot
                        state["data"][slot] = padded
                        state["labels"][slot] = 0
                        state["done"][slot] = False
                        state["occupied"][slot] = True
                        if cont_slots:
                            state["slot.started"][slot] = False
                        for name in ("inertia", "iterations", "converged",
                                     "n_clusters", "noise", "expansions"):
                            state[name][slot] = 0
                        jp["lengths"][slot] = int(req.n_points)
                        jp["seeds"][slot] = int(req.params.get("seed", 0))
                        jp["request_ids"][slot] = req.request_id
                        jp["tenants"][slot] = req.tenant
                        jp["cache_keys"][slot] = req.cache_key or ""
                        jp["trace_ids"][slot] = req.trace_id or ""
                        traces[slot] = req.trace_id or ""
                        live[slot] = req
                        joined[0] += 1
                    # no join-time checkpoint: the joiner's WAL entry stays
                    # live until it retires, so a crash in the window
                    # replays it (at-least-once, like any admitted request);
                    # the next periodic save persists it with the job
                    req.job_id = job_id
                    if tr is not None and req.trace_id:
                        tr.mark(req.trace_id, "join", job_id=job_id,
                                slot=slot)
                    views.append(ItemView(
                        index=slot, x_pad=padded,
                        length=int(req.n_points),
                        seed=int(req.params.get("seed", 0)),
                        mid_state=None,
                    ))
                return views

        # one execute-attempt span per trace, journaled at begin
        # (announce): if this process is SIGKILL'd mid-batch, the on-disk
        # span_start is the first attempt's footprint, and the process
        # that resumes the job emits a resume mark + a second attempt span
        # under the same trace ids (they ride in the job record)
        live_traces = list(dict.fromkeys(t for t in traces if t))
        exec_spans = []
        if tr is not None:
            for tid in live_traces:
                if resumed:
                    tr.mark(tid, "resume", job_id=job_id,
                            executor=jp["executor"])
                exec_spans.append(tr.begin(
                    tid, "execute", announce=True, executor=jp["executor"],
                    job_id=job_id, resumed=resumed))

        t0 = time.time()
        hb = max(0.05, min(1.0, self.jobs.heartbeat_timeout / 4.0))
        error: Optional[BaseException] = None
        with HoldAlive(self.jobs, job_id, interval=hb):
            try:
                outcome = paradigm.execute(
                    plan, items, token, on_item_done, on_item_state,
                    state_interval=self.checkpoint_every,
                    boundary_hook=boundary,
                )
            except BaseException as e:
                error = e
        exec_s = time.time() - t0
        # host/device split: checkpointing + progress reporting is host
        # bookkeeping; the remainder of the exec window is the paradigm's
        # compute share (kernel launches, device sync, result copies)
        host_s = min(host[0], exec_s)
        device_s = max(0.0, exec_s - host_s)

        if error is not None:
            for h in exec_spans:
                h.finish(error=repr(error))
            self.jobs.report_progress(job_id, error=repr(error))
            self.jobs.transition(job_id, JobState.FAILED)
            raise error

        for h in exec_spans:
            h.finish(suspended=bool(outcome.suspended))

        # a continuous outcome reports only the OCCUPIED slots (free ones
        # are padding, not requests); legacy batches are fully occupied
        idxs = [i for i in range(jp["size"]) if bool(state["occupied"][i])]
        cache_keys = list(jp.get("cache_keys") or [""] * jp["size"])
        common = dict(
            job_id=job_id, algo=jp["algo"], executor=jp["executor"],
            resumed=resumed, exec_s=exec_s, size=len(idxs),
            capacity=jp["capacity"], n_max=jp["n_max"],
            request_ids=[jp["request_ids"][i] for i in idxs],
            tenants=[jp["tenants"][i] for i in idxs],
            cache_keys=[cache_keys[i] for i in idxs],
            plan=plan.summary(),
            lengths=[int(jp["lengths"][i]) for i in idxs],
            host_s=host_s, device_s=device_s,
            continuous=cont, joined=joined[0], retired=retired[0],
        )
        if outcome.suspended:
            with lock:
                if outcome.item_index is not None:
                    state["active"] = np.asarray(True)
                    state["item"] = np.int32(outcome.item_index)
                    for k, v in (outcome.mid_state or {}).items():
                        state[f"mid.{k}"] = np.asarray(v)
                else:
                    state["active"] = np.asarray(False)
                save()
            self.jobs.transition(job_id, JobState.SUSPENDED)
            if tr is not None:
                for tid in live_traces:
                    tr.mark(tid, "suspend", job_id=job_id,
                            item_index=outcome.item_index)
            return BatchOutcome(suspended=True, **common)

        with lock:
            save()
        self.jobs.transition(job_id, JobState.SUCCEEDED)
        return BatchOutcome(
            suspended=False,
            results=[self._item_result(jp, state, i) for i in idxs],
            **common)

    @staticmethod
    def _item_result(jp: Dict[str, Any], state: Dict[str, np.ndarray],
                     i: int) -> Dict[str, Any]:
        n = int(jp["lengths"][i])
        r: Dict[str, Any] = {
            "algo": jp["algo"],
            "executor": jp["executor"],
            "labels": np.array(state["labels"][i][:n]),
        }
        if jp["algo"] == "dbscan":
            r["n_clusters"] = int(state["n_clusters"][i])
            r["noise"] = int(state["noise"][i])
            r["expansions"] = int(state["expansions"][i])
        else:
            r["inertia"] = float(state["inertia"][i])
            r["iterations"] = int(state["iterations"][i])
            r["converged"] = bool(state["converged"][i])
        return r

    # -- restart / resume ----------------------------------------------------

    def resume_suspended(
        self,
        token: Optional[CancellationToken] = None,
        progress_hook=None,
    ) -> List[BatchOutcome]:
        """The reattach path: sweep orphans, resume every SUSPENDED batch.

        RUNNING jobs whose owner died (stale heartbeat) are first swept to
        SUSPENDED by :meth:`JobStore.recover_orphans`, then every suspended
        service batch is claimed and driven to completion from its latest
        verified checkpoint.
        """
        self.jobs.recover_orphans()
        outcomes: List[BatchOutcome] = []
        for job in self.jobs.list_jobs(JobState.SUSPENDED):
            if job.kind != SERVICE_JOB_KIND:
                continue
            if token is not None and token.cancelled():
                break
            claimed = self.jobs.claim(job.job_id)
            if claimed is None:
                continue
            jp = job.params
            ckpt = self._ckpt(job.job_id)
            step = ckpt.latest_step()
            if step is None:
                self.jobs.report_progress(
                    job.job_id, error="no checkpoint to resume from")
                self.jobs.transition(job.job_id, JobState.FAILED)
                continue
            # prefer the checkpoint manifest's params: a continuous batch
            # admits joiners AFTER enqueue, and only the periodic saves
            # (state + metadata written atomically) carry the updated slot
            # roster — the job row still holds the formation-time view
            try:
                meta = ckpt.manifest(step).get("metadata") or {}
                jp = meta.get("params") or jp
            except Exception:
                logger.exception(
                    "unreadable manifest metadata for job %d step %d; "
                    "resuming from the job record's params", job.job_id,
                    step)
            template = self._blank_state(jp)
            restored = ckpt.restore(step, template)
            # np.array (not asarray): the state dict is mutated in place
            # during execution and must own writable copies
            state = {k: np.array(v) for k, v in restored.items()}
            outcomes.append(self._execute(
                job.job_id, jp, state, token,
                progress_hook=progress_hook, resumed=True,
            ))
        return outcomes
