"""Versioned runtime configuration: the live-reload control surface.

Every tuning knob an operator may want to turn *without restarting* —
tenant rate limits, joule budgets, backlog bounds, the power cap, the
bucket policy, the continuous-batching join window — is collected into
one immutable :class:`ServiceConfig` snapshot with a monotonically
increasing ``config_epoch``.  ``ClusteringService.apply_config`` is the
only mutation path: it validates the *whole* candidate config before
touching anything (a reload either applies completely or not at all),
then swaps the live objects' fields and bumps the epoch.

The epoch is the observability contract: it rides in
``metrics_snapshot()["config"]``, in worker ``/healthz`` heartbeats, and
is stamped onto every request's ``enqueue`` span — so "which config was
this request admitted under?" has an answer, and a fleet-wide reload can
be verified by watching every worker's epoch converge.

Deliberately NOT reloadable: anything whose construction happens once
(WAL on/off, registry, executor lanes, cache sizing, the *existence* of
a power-cap pacer).  Those need the rolling-restart path — and
``apply_config`` says so explicitly rather than half-applying.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.service.bucketing import make_policy

__all__ = ["ServiceConfig", "RELOADABLE_FIELDS"]

# the knobs POST /reload may change — everything else is restart-only
RELOADABLE_FIELDS = (
    "tenant_rate",
    "tenant_burst",
    "tenant_joule_rate",
    "tenant_joule_burst",
    "max_backlog",
    "max_per_tenant",
    "power_cap_watts",
    "power_cap_burst_joules",
    "bucket_policy",
    "join_window_s",
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """One immutable snapshot of the reloadable knobs."""

    epoch: int = 0
    tenant_rate: Optional[float] = None
    tenant_burst: int = 8
    tenant_joule_rate: Optional[float] = None
    tenant_joule_burst: float = 50.0
    max_backlog: int = 256
    max_per_tenant: int = 64
    power_cap_watts: Optional[float] = None
    power_cap_burst_joules: Optional[float] = None
    bucket_policy: Optional[str] = None      # policy spec, e.g. "linear:64"
    join_window_s: Optional[float] = None

    @classmethod
    def from_service(cls, service: Any, *, epoch: int = 0) -> "ServiceConfig":
        """Read the current live values off a :class:`ClusteringService`."""
        pacer = service.pacer
        return cls(
            epoch=epoch,
            tenant_rate=service.queue.tenant_rate,
            tenant_burst=service.queue.tenant_burst,
            tenant_joule_rate=service.queue.tenant_joule_rate,
            tenant_joule_burst=service.queue.tenant_joule_burst,
            max_backlog=service.queue.max_backlog,
            max_per_tenant=service.queue.max_per_tenant,
            power_cap_watts=pacer.watts if pacer is not None else None,
            power_cap_burst_joules=(pacer.burst_joules
                                    if pacer is not None else None),
            bucket_policy=getattr(service.bucket_policy, "name", None),
            join_window_s=service.join_window_s,
        )

    def replace(self, changes: Dict[str, Any]) -> "ServiceConfig":
        """Candidate config with ``changes`` applied and the epoch bumped.

        Rejects unknown keys loudly — a typo'd knob name must fail the
        reload, not silently reload nothing.
        """
        unknown = sorted(set(changes) - set(RELOADABLE_FIELDS))
        if unknown:
            raise ValueError(
                f"unknown config field(s) {unknown}; reloadable: "
                f"{', '.join(RELOADABLE_FIELDS)}")
        return dataclasses.replace(self, epoch=self.epoch + 1, **changes)

    def validate(self) -> None:
        """Raise ``ValueError`` unless every field is applicable."""
        def positive(name: str, value: Any, *, optional: bool = True) -> None:
            if value is None:
                if not optional:
                    raise ValueError(f"{name} must be set")
                return
            if not isinstance(value, (int, float)) or float(value) <= 0:
                raise ValueError(f"{name} must be a positive number, "
                                 f"got {value!r}")

        positive("tenant_rate", self.tenant_rate)
        positive("tenant_joule_rate", self.tenant_joule_rate)
        positive("power_cap_watts", self.power_cap_watts)
        positive("power_cap_burst_joules", self.power_cap_burst_joules)
        positive("tenant_joule_burst", self.tenant_joule_burst,
                 optional=False)
        if not isinstance(self.tenant_burst, int) or self.tenant_burst < 1:
            raise ValueError(f"tenant_burst must be an int >= 1, "
                             f"got {self.tenant_burst!r}")
        if not isinstance(self.max_backlog, int) or self.max_backlog < 1:
            raise ValueError(f"max_backlog must be an int >= 1, "
                             f"got {self.max_backlog!r}")
        if (not isinstance(self.max_per_tenant, int)
                or self.max_per_tenant < 1):
            raise ValueError(f"max_per_tenant must be an int >= 1, "
                             f"got {self.max_per_tenant!r}")
        if self.join_window_s is not None and float(self.join_window_s) < 0:
            raise ValueError(f"join_window_s must be >= 0, "
                             f"got {self.join_window_s!r}")
        if self.bucket_policy is not None:
            try:                      # parse-only: proves the spec is sane
                make_policy(self.bucket_policy)
            except Exception as exc:
                raise ValueError(
                    f"bad bucket_policy spec {self.bucket_policy!r}: "
                    f"{exc}") from None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
