"""Fleet tier: N service processes behind one consistent-hash front door.

The single-process :class:`~repro_torch.service.ClusteringService` is
crash-safe (WAL), self-tuning (bucketing), and observable
(tracing/telemetry); this package makes *processes* the next schedulable
resource.  On the card every worker is its own process with its own CUDA
context, and all of them share the one device:

- :class:`~repro_torch.service.fleet.manager.WorkerManager` —
  spawn/supervise N worker processes (own workdir + WAL lock each),
  heartbeat them, SIGKILL the wedged, and fail over a dead worker's WAL
  onto a survivor.
- :class:`~repro_torch.service.fleet.router.FleetRouter` —
  MiningClient-shaped submit/result API with bounded-load consistent-hash
  tenant placement, typed retry/backoff, sticky streaming tenants, and
  fleet-level metrics/trace fan-out (``repro_fleet_*`` with a ``worker``
  label).
- :class:`~repro_torch.service.fleet.hashring.ConsistentHashRing` — the
  placement structure (stable under join/leave, hot tenants spill).
- :mod:`~repro_torch.service.fleet.worker` — the worker process entry
  point and its RPC door; :mod:`~repro_torch.service.fleet.rpc` — the
  framed numpy-over-HTTP transport with typed error mapping.
"""

from repro_torch.service.fleet.hashring import ConsistentHashRing
from repro_torch.service.fleet.manager import WorkerManager, WorkerSpec
from repro_torch.service.fleet.router import (FleetHandle, FleetRouter,
                                              FleetStream,
                                              render_fleet_prometheus)
from repro_torch.service.fleet.rpc import RemoteError, RpcError
from repro_torch.service.fleet.worker import FleetWorker

__all__ = [
    "ConsistentHashRing",
    "FleetHandle",
    "FleetRouter",
    "FleetStream",
    "FleetWorker",
    "RemoteError",
    "RpcError",
    "WorkerManager",
    "WorkerSpec",
    "render_fleet_prometheus",
]
