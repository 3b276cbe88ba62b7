"""Device-class energy model: the one source of truth for power/cost.

The paper's Fig. 9 observation — power draw is roughly *constant per
device class*, so energy ≈ active-power × runtime — is the whole model.
This module is where the constants live:
``P_ACTIVE_WATTS`` used to be duplicated across ``benchmarks/energy.py``,
``service/metrics.py``, and (as ``DEFAULT_JOULES_PER_WORK``)
``service/dispatch.py``.  All three now alias the profiles here.

A :class:`DeviceClass` is a simulated SoC cluster in the Android
big.LITTLE sense.  The numbers mirror the Adreno-vs-CPU tables in
SNIPPETS.md: the GPU ("big") class draws more instantaneous power but
retires work 3–4× faster, so above a crossover work size it is the
*lower-energy* choice — exactly the paper's speed/energy frontier.

- ``little`` — CPU-class (ARM NEON / numpy-mt).  3.0 W at 5e7 work/s;
  its joules-per-work (6e-8) is bit-identical to the historical
  ``DEFAULT_JOULES_PER_WORK = 3.0 / 5e7`` prior, so plans priced here
  match pre-refactor plans exactly.
- ``big`` — GPU-class (Adreno / cuda-kernel, torch-ref, distributed).  7.5 W
  at 1.75e8 work/s (3.5× the little rate, per the SNIPPETS speedups)
  plus a fixed dispatch overhead tuned so the energy crossover between
  the classes lands at ``ENERGY_CROSSOVER_WORK`` — the same ``1 << 21``
  boundary ``dispatch.SMALL_WORK_THRESHOLD`` already routes on, so the
  energy-optimal class and the latency-optimal paradigm agree.

:class:`PowerCapPacer` is the service-wide ``--power-cap`` control
surface: a joule token bucket refilled at the cap wattage.  Dispatch
acquires a batch's predicted joules before running it; when the bucket
runs dry the lane blocks, trading p50 latency for modeled watts ≤ cap
(and usually *better* joules/point, because paced dispatch lets batches
fill before flushing).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

# Work size (estimate_work units) where big/little energy curves cross.
# Kept equal to dispatch.SMALL_WORK_THRESHOLD (imported there, asserted
# in tests) so class selection coincides with paradigm routing.
ENERGY_CROSSOVER_WORK = float(1 << 21)


@dataclass(frozen=True)
class DeviceClass:
    """One simulated SoC cluster: constant active power, linear runtime.

    ``modeled_seconds`` is affine (overhead + work/rate) so small work
    on the big class pays the kernel-launch/transfer tax the paper
    measures — which is what makes "little" win below the crossover.
    """

    name: str
    active_watts: float        # constant draw while executing (Fig. 9)
    work_per_second: float     # estimate_work units retired per second
    dispatch_overhead_s: float = 0.0   # fixed launch/transfer tax

    @property
    def joules_per_work(self) -> float:
        """Asymptotic J per work unit (ignores the fixed overhead)."""
        return self.active_watts / self.work_per_second

    def modeled_seconds(self, work: float) -> float:
        return self.dispatch_overhead_s + max(0.0, work) / self.work_per_second

    def modeled_joules(self, work: float) -> float:
        return self.active_watts * self.modeled_seconds(work)


LITTLE = DeviceClass(name="little", active_watts=3.0, work_per_second=5e7)

_BIG_WATTS = 7.5
_BIG_RATE = 1.75e8
# Solve big.modeled_joules(X) == little.modeled_joules(X) for the
# overhead, with X = ENERGY_CROSSOVER_WORK:
#   big_W * (oh + X/big_rate) = little_jpw * X
_BIG_OVERHEAD_S = ENERGY_CROSSOVER_WORK * (
    LITTLE.joules_per_work - _BIG_WATTS / _BIG_RATE) / _BIG_WATTS

BIG = DeviceClass(name="big", active_watts=_BIG_WATTS,
                  work_per_second=_BIG_RATE,
                  dispatch_overhead_s=_BIG_OVERHEAD_S)

DEVICE_CLASSES: Dict[str, DeviceClass] = {c.name: c for c in (BIG, LITTLE)}

# paradigm name -> simulated device class it executes on
PARADIGM_DEVICE_CLASS: Dict[str, str] = {
    "cuda-kernel": "big",
    "torch-ref": "big",
    "distributed": "big",
    "numpy-mt": "little",
}

# Deprecated alias: the pre-refactor scalar (little-class watts).  Kept
# so downstream code/tests importing the old name keep working; new
# code should price per class via the profiles above.
P_ACTIVE_WATTS = LITTLE.active_watts


def device_class_for(paradigm: Optional[str]) -> DeviceClass:
    """The device class a paradigm executes on (little for unknowns —
    the conservative CPU assumption)."""
    return DEVICE_CLASSES[PARADIGM_DEVICE_CLASS.get(paradigm or "",
                                                    "little")]


def active_watts_for(executor: Optional[str]) -> float:
    return device_class_for(executor).active_watts


def classify_work(work: float) -> DeviceClass:
    """Energy-optimal class for a work size: little below the crossover
    (the big class's launch tax dominates), big above it."""
    return LITTLE if work < ENERGY_CROSSOVER_WORK else BIG


class PowerCapPacer:
    """Joule token bucket enforcing a modeled-watts ceiling on dispatch.

    Refills at ``watts`` joules/second up to ``burst_joules``.
    :meth:`acquire` blocks until at least ``min(joules, burst)`` tokens
    are available, then deducts the *full* amount — the bucket may go
    negative (debt), so a single batch larger than the burst still runs
    while long-run average draw stays ≤ the cap.

    Thread-safe; many lanes block on one pacer.  ``clock`` is
    injectable for deterministic tests.
    """

    def __init__(self, watts: float, burst_joules: Optional[float] = None,
                 *, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if watts <= 0:
            raise ValueError(f"power cap must be positive, got {watts}")
        self.watts = float(watts)
        # default burst: one second of headroom at the cap
        self.burst_joules = float(burst_joules
                                  if burst_joules is not None else watts)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._tokens = self.burst_joules
        self._stamp = clock()
        self.spent_joules = 0.0
        self.throttled_s = 0.0
        self.acquires = 0
        self.throttles = 0

    def _refill_locked(self, now: float) -> None:
        elapsed = max(0.0, now - self._stamp)
        self._tokens = min(self.burst_joules,
                           self._tokens + elapsed * self.watts)
        self._stamp = now

    def acquire(self, joules: float,
                abort: Optional[Callable[[], bool]] = None) -> float:
        """Block until the bucket can pay for ``joules``; returns the
        seconds spent throttled (0.0 on the fast path).  ``abort``
        short-circuits the wait (shutdown): the caller proceeds without
        the bucket being charged."""
        need = max(0.0, float(joules))
        waited = 0.0
        throttled = False
        while True:
            with self._lock:
                self._refill_locked(self._clock())
                # debt model: a batch bigger than the whole burst only
                # has to wait for a *full* bucket, then borrows the rest
                gate = min(need, self.burst_joules)
                if self._tokens >= gate:
                    self._tokens -= need
                    self.spent_joules += need
                    self.acquires += 1
                    if throttled:
                        self.throttles += 1
                        self.throttled_s += waited
                    return waited
                wait = (gate - self._tokens) / self.watts
            if abort is not None and abort():
                return waited
            throttled = True
            wait = min(max(wait, 1e-4), 0.25)
            self._sleep(wait)
            waited += wait

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            self._refill_locked(self._clock())
            return {
                "power_cap_watts": self.watts,
                "burst_joules": self.burst_joules,
                "tokens_joules": self._tokens,
                "spent_joules": self.spent_joules,
                "throttled_s_total": self.throttled_s,
                "acquires": self.acquires,
                "throttles": self.throttles,
            }
