"""Clustering-as-a-service: batched multi-tenant mining on the port's cores.

The paper ships a single-activity app that submits one mining job at a time
to WorkManager.  This subsystem is that app generalised to an async service
front door: many tenants submit DBSCAN/K-Means requests through a
:class:`MiningClient` and get futures back, an admission queue keeps them
fair, bounded, and deadline-aware across priority lanes, a micro-batcher
coalesces compatible requests into padded batches, a dispatcher assigns
each batch to the least-loaded compatible executor lane (one queue + worker
per paradigm — the paper's GPU-vs-CPU comparison as a runtime dispatch
decision), and a preemption-safe executor runs each batch as a durable job
that survives being killed at any moment.  Unbounded point streams ride
:class:`StreamingSession` — mini-batch K-Means with per-tenant model state
in the checkpoint store.

The service runs on one device (``device="cuda"`` by default).  Its WAL
can be shipped to a warm standby that promotes into a live service
(``replicate``), and the fleet tier runs N service processes behind a
consistent-hash router that fails a SIGKILLed worker's WAL over onto a
survivor and restarts workers one at a time (``fleet``); on the card
every worker holds its own CUDA context on the one device.  The
reference's distributed lane is not ported yet; a request too large for
one device is refused at admission (``RequestTooLarge``).

    client    — MiningClient + ResultHandle: the async front door
    session   — StreamingSession: checkpointed per-tenant streams
    queue     — admission control: priority lanes, deadlines, fairness,
                per-tenant token-bucket rate limits
    batcher   — micro-batching: coalesce + pad + max-wait deadline
    bucketing — pluggable batch-shape bucket policies (pow2 / linear /
                adaptive autotuner fitted to observed request shapes)
    dispatch  — paradigm registry + plan/execute cost model
                (cuda-kernel/torch-ref/numpy-mt)
    exec_cache — prepared Lloyd steps per bucket shape, warmed at start
    executor  — durable batch execution: jobs + checkpoints + resume
    wal       — write-ahead admission log: admitted means durable
                (crash-safe replay of requests not yet batched)
    cache     — content-hash result cache (disk spill + TTL)
    energy    — device-class cost models (simulated big.LITTLE), the
                power-cap pacer, and the shared active-power constants
    metrics   — latency percentiles, batch occupancy, energy proxy +
                per-paradigm joules-per-work EWMA (dispatch feedback)
    trace     — span-based request tracer: one trace id from WAL append
                to delivery, surviving SIGKILL via the event log
    telemetry — Prometheus exposition + HTTP exporter, rotating JSONL
                event log, SLO burn-rate evaluation
    config    — versioned ServiceConfig: the live-reload control surface
    replicate — warm-standby WAL replication: segment shipper + standby
                replica that can promote into a live service
    faults    — deterministic fault-injection points (REPRO_FAULT) the
                crash-matrix tests drive
    service   — the engine tying it together (executor lane pool)
    fleet     — the horizontal tier: N worker processes behind a
                consistent-hash router, heartbeat-supervised, with
                WAL-replay failover (admitted means durable, fleet-wide)
"""

from repro_torch.service.batcher import BatchKey, MicroBatch, MicroBatcher
from repro_torch.service.bucketing import (
    AdaptivePolicy,
    BucketPolicy,
    LinearPolicy,
    Pow2Policy,
    make_policy,
)
from repro_torch.service.cache import ResultCache, content_key
from repro_torch.service.client import MiningClient, ResultHandle
from repro_torch.service.config import RELOADABLE_FIELDS, ServiceConfig
from repro_torch.service.dispatch import (
    EXECUTOR_CUDA,
    EXECUTOR_DISTRIBUTED,
    EXECUTOR_NUMPY_MT,
    EXECUTOR_TORCH_REF,
    ExecutionPlan,
    ParadigmRegistry,
    TorchParadigm,
    default_registry,
)
from repro_torch.service.energy import (
    BIG,
    LITTLE,
    DeviceClass,
    PowerCapPacer,
    device_class_for,
)
from repro_torch.service.executor import BatchExecutor, BatchOutcome
from repro_torch.service.faults import FaultInjected, FaultPlan, parse_spec
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.queue import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    PRIORITY_NORMAL,
    AdmissionQueue,
    BacklogFull,
    EnergyBudgetExceeded,
    JobSuspended,
    MiningRequest,
    RateLimited,
    RequestCancelled,
    RequestDropped,
    RequestTooLarge,
)
from repro_torch.service.service import ClusteringService, ExecutorLane
from repro_torch.service.session import StreamingSession
from repro_torch.service.telemetry import (
    EventLog,
    SLOEvaluator,
    TelemetryServer,
    exposition_errors,
    read_events,
    render_prometheus,
)
from repro_torch.service.trace import (
    RequestTracer,
    Span,
    chrome_trace,
    new_trace_id,
    read_spans,
)
from repro_torch.service.replicate import StandbyReplica, WalShipper
from repro_torch.service.wal import RequestLog, WalLocked, WalRecord
from repro_torch.service.fleet import (
    ConsistentHashRing,
    FleetHandle,
    FleetRouter,
    FleetStream,
    FleetWorker,
    WorkerManager,
    render_fleet_prometheus,
)

__all__ = [
    "ConsistentHashRing",
    "FleetHandle",
    "FleetRouter",
    "FleetStream",
    "FleetWorker",
    "WorkerManager",
    "render_fleet_prometheus",
    "AdaptivePolicy",
    "AdmissionQueue",
    "BacklogFull",
    "BatchExecutor",
    "BatchKey",
    "BucketPolicy",
    "BatchOutcome",
    "BIG",
    "ClusteringService",
    "DeviceClass",
    "EnergyBudgetExceeded",
    "LITTLE",
    "PowerCapPacer",
    "device_class_for",
    "EventLog",
    "FaultInjected",
    "FaultPlan",
    "RELOADABLE_FIELDS",
    "ServiceConfig",
    "parse_spec",
    "EXECUTOR_CUDA",
    "EXECUTOR_DISTRIBUTED",
    "EXECUTOR_NUMPY_MT",
    "EXECUTOR_TORCH_REF",
    "ExecutionPlan",
    "ExecutorLane",
    "JobSuspended",
    "LinearPolicy",
    "MicroBatch",
    "MicroBatcher",
    "MiningClient",
    "MiningRequest",
    "PRIORITY_BATCH",
    "PRIORITY_INTERACTIVE",
    "PRIORITY_NORMAL",
    "ParadigmRegistry",
    "Pow2Policy",
    "RateLimited",
    "RequestCancelled",
    "RequestDropped",
    "RequestLog",
    "RequestTooLarge",
    "RequestTracer",
    "ResultCache",
    "SLOEvaluator",
    "Span",
    "StandbyReplica",
    "WalShipper",
    "TelemetryServer",
    "WalLocked",
    "WalRecord",
    "ResultHandle",
    "ServiceMetrics",
    "TorchParadigm",
    "StreamingSession",
    "chrome_trace",
    "content_key",
    "default_registry",
    "exposition_errors",
    "make_policy",
    "new_trace_id",
    "read_events",
    "read_spans",
    "render_prometheus",
]
