"""Service metrics: latency percentiles, batch occupancy, energy proxy.

The energy proxy is the model from ``benchmarks/energy.py`` (the paper's
Fig. 9 finding: power draw is roughly constant per device class, so energy
differences come from runtime — E = P_active * t).  Per-batch execution
seconds times the active-power constant gives modeled joules per paradigm,
putting an energy axis on every serving run without hardware counters.

Beyond the scorecard, the proxy now closes a control loop: every batch
that reports its plan's ``work`` estimate updates a per-paradigm EWMA of
modeled joules per unit work (:meth:`ServiceMetrics.energy_hints`), which
the dispatcher feeds back into ``ParadigmRegistry.select`` as a
tie-breaker — the paradigm that has been observed cheaper per op wins
ties, which is the paper's Fig. 9 comparison applied continuously at
runtime instead of once in a benchmark table.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import OrderedDict, defaultdict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.service.energy import (DEVICE_CLASSES, active_watts_for,
                                  device_class_for)
# Deprecated alias: the single scalar this module used to define is now
# the little-class profile in service/energy.py (one source of truth).
from repro_torch.service.energy import P_ACTIVE_WATTS  # noqa: F401  (re-export)

# Percentiles are computed over a sliding window so a long-lived service
# never grows its metric state without bound; totals are kept as counters.
DEFAULT_WINDOW = 10_000

# EWMA smoothing for the per-paradigm joules-per-work estimate: heavy
# enough history that one slow batch (cold jit compile) cannot flip
# dispatch, light enough to track a drifting host.
ENERGY_EWMA_ALPHA = 0.2

# Staleness decay for the dispatch hints: an executor that stops being
# selected has its EWMA pulled toward its device class's static prior by
# this fraction per batch *anyone* runs, so one bad early sample (cold
# compile) can no longer starve a paradigm forever — after ~2/0.02 = 100
# foreign batches the hint has mostly recovered and the paradigm gets
# re-explored.
HINT_STALENESS_DECAY = 0.02

# Sliding window for the modeled-watts gauge (power = joules in the last
# WATTS_WINDOW_S seconds / window) — what the --power-cap gate scrapes.
WATTS_WINDOW_S = 10.0

# The compiled-shape tracker is an LRU bounded at this many entries: it
# mirrors what a real executable cache can hold, so "first sight" means
# "not in tracker memory" — a shape evicted and seen again recounts as a
# recompile, exactly as the device would recompile it.
MAX_TRACKED_SHAPES = 4096

# Per-(stage, executor) latency windows for the stage breakdown, and a
# cardinality cap so a misbehaving caller cannot mint unbounded series.
STAGE_WINDOW = 2048
MAX_STAGE_SERIES = 512


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


@dataclasses.dataclass
class RequestRecord:
    tenant: str
    algo: str
    executor: str
    latency_s: float
    queue_wait_s: float
    cache_hit: bool


@dataclasses.dataclass
class BatchRecord:
    algo: str
    executor: str
    size: int
    capacity: int
    n_max: int
    exec_s: float
    resumed: bool
    real_points: int = 0       # sum of item lengths (0 = not reported)
    host_s: float = 0.0        # exec time spent on host work (checkpoints)
    device_s: float = 0.0      # exec_s minus host bookkeeping
    device_class: str = ""     # energy.DEVICE_CLASSES key (from the plan)

    @property
    def occupancy(self) -> float:
        return self.size / max(1, self.capacity)

    @property
    def padded_points(self) -> int:
        """Points actually allocated/computed: every item pads to n_max."""
        return self.size * self.n_max

    @property
    def watts(self) -> float:
        """Active power of the class this batch ran on (Fig. 9: constant
        per class), falling back to the executor's static class map."""
        cls = DEVICE_CLASSES.get(self.device_class)
        return (cls.active_watts if cls is not None
                else active_watts_for(self.executor))

    @property
    def modeled_joules(self) -> float:
        return self.watts * self.exec_s


class ServiceMetrics:
    """Thread-safe accumulator; snapshot() renders the serving scorecard.

    Per-record state lives in bounded sliding windows (percentiles are
    window-local); lifetime totals live in plain counters.
    """

    def __init__(self, window: int = DEFAULT_WINDOW,
                 max_tracked_shapes: int = MAX_TRACKED_SHAPES) -> None:
        self._lock = threading.Lock()
        self._requests: Deque[RequestRecord] = deque(maxlen=window)
        self._batches: Deque[BatchRecord] = deque(maxlen=max(1, window // 4))
        self.suspended_batches = 0
        self.resumed_batches = 0
        self.total_requests = 0
        self.total_cache_hits = 0
        self.total_batches = 0
        self.total_joules = 0.0
        # executor -> EWMA modeled joules per unit work (the dispatch hint)
        self._joules_per_work: Dict[str, float] = {}
        # executor -> total_batches index of its last EWMA update: the
        # staleness clock driving decay-toward-prior in energy_hints()
        self._hint_updated: Dict[str, int] = {}
        # device class -> lifetime energy accounting (the frontier axis)
        self._class_totals: Dict[str, Dict[str, float]] = {}
        # (monotonic stamp, joules) of recent batches for modeled_watts()
        self._joule_events: Deque[Tuple[float, float]] = deque(maxlen=4096)
        # -- bucketing scorecard (lifetime) ---------------------------------
        # real vs padded points executed, and the distinct compiled-program
        # shapes seen: each fresh (executor, algo, features, n_max) combo
        # is a jit compile the executable cache must hold — the recompile
        # axis of the bucketing tradeoff (padding waste vs cache misses).
        # LRU-bounded: a long-lived service admitting arbitrary shapes must
        # not grow this without limit, so the oldest-seen shape is evicted
        # past ``max_tracked_shapes`` (counted in ``shape_evictions``); an
        # evicted shape seen again recounts as a recompile, which matches
        # what a same-sized executable cache would actually do.
        self.total_real_points = 0
        self.total_padded_points = 0
        self.max_tracked_shapes = max(1, int(max_tracked_shapes))
        self._compiled_shapes: "OrderedDict[Tuple[str, str, int, int], None]"
        self._compiled_shapes = OrderedDict()
        self.recompiles = 0
        self.shape_evictions = 0
        # -- outcome window (SLO input) + per-stage latency breakdown -------
        self.total_failures = 0
        self._failure_reasons: Dict[str, int] = {}
        self._outcomes: Deque[bool] = deque(maxlen=window)
        self._stages: Dict[Tuple[str, str], Deque[float]] = {}
        self._stage_counts: Dict[Tuple[str, str], int] = {}
        # -- continuous batching (lifetime) ---------------------------------
        # joins: queued requests swapped into an in-flight batch's freed
        # slots; early_retires: items whose futures resolved before their
        # batch drained; slot_occupancy window: filled-slot fraction of
        # each continuous batch over its whole run
        self.total_joins = 0
        self.total_early_retires = 0
        self.continuous_batches = 0
        self._slot_occupancy: Deque[float] = deque(maxlen=max(1, window // 4))

    def record_request(
        self,
        *,
        tenant: str,
        algo: str,
        executor: str,
        latency_s: float,
        queue_wait_s: float = 0.0,
        cache_hit: bool = False,
    ) -> None:
        with self._lock:
            self._requests.append(RequestRecord(
                tenant=tenant, algo=algo, executor=executor,
                latency_s=latency_s, queue_wait_s=queue_wait_s,
                cache_hit=cache_hit,
            ))
            self.total_requests += 1
            self._outcomes.append(True)
            if cache_hit:
                self.total_cache_hits += 1

    def record_failure(self, reason: str) -> None:
        """A request finished with an error (feeds the SLO error budget)."""
        with self._lock:
            self.total_failures += 1
            self._outcomes.append(False)
            key = str(reason)
            if key not in self._failure_reasons and \
                    len(self._failure_reasons) >= 64:
                key = "other"          # bound reason cardinality
            self._failure_reasons[key] = self._failure_reasons.get(key, 0) + 1

    def record_stage(self, stage: str, dur_s: float,
                     executor: Optional[str] = None) -> None:
        """One span's duration for the per-stage latency breakdown."""
        key = (str(stage), str(executor or ""))
        with self._lock:
            dq = self._stages.get(key)
            if dq is None:
                if len(self._stages) >= MAX_STAGE_SERIES:
                    return             # cardinality bound: drop, don't grow
                dq = deque(maxlen=STAGE_WINDOW)
                self._stages[key] = dq
            dq.append(float(dur_s))
            self._stage_counts[key] = self._stage_counts.get(key, 0) + 1

    def record_batch(
        self,
        *,
        algo: str,
        executor: str,
        size: int,
        capacity: int,
        n_max: int,
        exec_s: float,
        resumed: bool = False,
        work: float = 0.0,
        real_points: int = 0,
        features: int = 0,
        host_s: float = 0.0,
        device_s: float = 0.0,
        device_class: str = "",
    ) -> None:
        cls_name = (device_class
                    or device_class_for(executor).name)
        watts = DEVICE_CLASSES[cls_name].active_watts \
            if cls_name in DEVICE_CLASSES else active_watts_for(executor)
        with self._lock:
            self._batches.append(BatchRecord(
                algo=algo, executor=executor, size=size, capacity=capacity,
                n_max=n_max, exec_s=exec_s, resumed=resumed,
                real_points=int(real_points),
                host_s=float(host_s), device_s=float(device_s),
                device_class=cls_name,
            ))
            self.total_batches += 1
            joules = watts * exec_s
            self.total_joules += joules
            self._joule_events.append((time.monotonic(), joules))
            cls_tot = self._class_totals.setdefault(cls_name, {
                "batches": 0, "exec_s": 0.0, "modeled_joules": 0.0,
                "real_points": 0})
            cls_tot["batches"] += 1
            cls_tot["exec_s"] += float(exec_s)
            cls_tot["modeled_joules"] += joules
            cls_tot["real_points"] += int(real_points)
            if real_points > 0:
                self.total_real_points += int(real_points)
                self.total_padded_points += int(size) * int(n_max)
            shape = (executor, algo, int(features), int(n_max))
            if shape in self._compiled_shapes:
                self._compiled_shapes.move_to_end(shape)
            else:
                self._compiled_shapes[shape] = None
                self.recompiles += 1
                while len(self._compiled_shapes) > self.max_tracked_shapes:
                    self._compiled_shapes.popitem(last=False)
                    self.shape_evictions += 1
            if resumed:
                self.resumed_batches += 1
            if work > 0.0 and exec_s > 0.0:
                inst = watts * exec_s / work
                # fold in accumulated staleness decay first, so a paradigm
                # resuming after a long idle blends the *recovered* value
                old = self._decayed_hint_locked(executor)
                self._joules_per_work[executor] = (
                    inst if old is None
                    else (1.0 - ENERGY_EWMA_ALPHA) * old
                    + ENERGY_EWMA_ALPHA * inst)
                self._hint_updated[executor] = self.total_batches

    def _decayed_hint_locked(self, name: str) -> Optional[float]:
        """The stored EWMA pulled toward its device class's static prior
        by ``HINT_STALENESS_DECAY`` per batch since its last update —
        an executor nobody selects converges back to the prior instead
        of being starved forever by one bad early sample."""
        value = self._joules_per_work.get(name)
        if value is None:
            return None
        stale = self.total_batches - self._hint_updated.get(
            name, self.total_batches)
        if stale <= 0:
            return value
        prior = device_class_for(name).joules_per_work
        keep = (1.0 - HINT_STALENESS_DECAY) ** stale
        return prior + (value - prior) * keep

    def energy_hints(self) -> Dict[str, float]:
        """Per-executor EWMA modeled joules per unit work (dispatch
        input), staleness-decayed toward each executor's class prior."""
        with self._lock:
            return {name: self._decayed_hint_locked(name)
                    for name in self._joules_per_work}

    def modeled_watts(self, window_s: float = WATTS_WINDOW_S) -> float:
        """Modeled power over the trailing window: joules of batches that
        finished in the last ``window_s`` seconds / window.  The gauge
        the ``--power-cap`` gate compares against the cap."""
        cutoff = time.monotonic() - max(1e-6, window_s)
        with self._lock:
            joules = sum(j for (t, j) in self._joule_events if t >= cutoff)
        return joules / max(1e-6, window_s)

    def record_suspended(self) -> None:
        with self._lock:
            self.suspended_batches += 1

    def record_continuous(self, *, joins: int, early_retires: int,
                          slot_occupancy: float) -> None:
        """One continuous batch's join/retire tallies and its mean
        filled-slot fraction (items served / capacity x rounds proxy)."""
        with self._lock:
            self.continuous_batches += 1
            self.total_joins += int(joins)
            self.total_early_retires += int(early_retires)
            self._slot_occupancy.append(float(slot_occupancy))

    def window_stats(self) -> Dict[str, Any]:
        """Windowed observations the SLO evaluator consumes."""
        with self._lock:
            latencies = [r.latency_s for r in self._requests]
            outcomes = list(self._outcomes)
        return {
            "latencies": latencies,
            "failures": sum(1 for ok in outcomes if not ok),
            "outcomes": len(outcomes),
        }

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            requests = list(self._requests)
            batches = list(self._batches)
            suspended = self.suspended_batches
            resumed = self.resumed_batches
            jpw = {name: self._decayed_hint_locked(name)
                   for name in self._joules_per_work}
            by_class = {name: dict(tot)
                        for name, tot in self._class_totals.items()}
            cutoff = time.monotonic() - WATTS_WINDOW_S
            watts_now = sum(j for (t, j) in self._joule_events
                            if t >= cutoff) / WATTS_WINDOW_S
            totals = {
                "requests": self.total_requests,
                "cache_hits": self.total_cache_hits,
                "batches": self.total_batches,
                "failures": self.total_failures,
                "modeled_joules": self.total_joules,
            }
            real_pts = self.total_real_points
            padded_pts = self.total_padded_points
            recompiles = self.recompiles
            tracked_shapes = len(self._compiled_shapes)
            shape_evictions = self.shape_evictions
            failures = self.total_failures
            by_reason = dict(self._failure_reasons)
            outcomes = list(self._outcomes)
            stage_windows = {k: list(v) for k, v in self._stages.items()}
            stage_counts = dict(self._stage_counts)
            continuous = {
                "batches": self.continuous_batches,
                "joins": self.total_joins,
                "early_retires": self.total_early_retires,
                "mean_slot_occupancy": (
                    sum(self._slot_occupancy) / len(self._slot_occupancy)
                    if self._slot_occupancy else 0.0),
            }

        latencies = [r.latency_s for r in requests]
        waits = [r.queue_wait_s for r in requests]
        by_executor: Dict[str, Dict[str, Any]] = {}
        groups: Dict[str, List[RequestRecord]] = defaultdict(list)
        for r in requests:
            groups[r.executor].append(r)
        batch_groups: Dict[str, List[BatchRecord]] = defaultdict(list)
        for b in batches:
            batch_groups[b.executor].append(b)
        for name in sorted(set(groups) | set(batch_groups)):
            rs, bs = groups.get(name, []), batch_groups.get(name, [])
            ls = [r.latency_s for r in rs]
            by_executor[name] = {
                "requests": len(rs),
                "p50_latency_s": percentile(ls, 50),
                "p99_latency_s": percentile(ls, 99),
                "batches": len(bs),
                "mean_occupancy": (
                    sum(b.occupancy for b in bs) / len(bs) if bs else 0.0),
                "exec_s": sum(b.exec_s for b in bs),
                "host_s": sum(b.host_s for b in bs),
                "device_s": sum(b.device_s for b in bs),
                "modeled_joules": sum(b.modeled_joules for b in bs),
                "joules_per_work": jpw.get(name),
            }

        # per-stage latency breakdown: aggregate across executors, with a
        # by-executor sub-block for spans that carried an executor attr
        stages: Dict[str, Dict[str, Any]] = {}
        for (stage, ex), vals in sorted(stage_windows.items()):
            entry = stages.setdefault(stage, {
                "count": 0, "window": 0, "_all": [], "by_executor": {}})
            entry["count"] += stage_counts.get((stage, ex), 0)
            entry["window"] += len(vals)
            entry["_all"].extend(vals)
            if ex:
                entry["by_executor"][ex] = {
                    "count": stage_counts.get((stage, ex), 0),
                    "p50_s": percentile(vals, 50),
                    "p99_s": percentile(vals, 99),
                }
        for entry in stages.values():
            vals = entry.pop("_all")
            entry["p50_s"] = percentile(vals, 50)
            entry["p99_s"] = percentile(vals, 99)
            entry["mean_s"] = sum(vals) / len(vals) if vals else 0.0

        by_bucket: Dict[str, int] = defaultdict(int)
        for b in batches:
            by_bucket[str(b.n_max)] += 1
        bucketing = {
            # lifetime counters (the per-batch window backs by_bucket only)
            "real_points": real_pts,
            "padded_points": padded_pts,
            "padding_waste": (1.0 - real_pts / padded_pts
                              if padded_pts else 0.0),
            "point_occupancy": (real_pts / padded_pts
                                if padded_pts else 0.0),
            "recompiles": recompiles,
            "tracked_shapes": tracked_shapes,
            "max_tracked_shapes": self.max_tracked_shapes,
            "shape_evictions": shape_evictions,
            "by_bucket": dict(by_bucket),
        }

        window_failures = sum(1 for ok in outcomes if not ok)
        errors = {
            "total_failures": failures,
            "window_outcomes": len(outcomes),
            "window_failures": window_failures,
            "window_error_rate": (window_failures / len(outcomes)
                                  if outcomes else 0.0),
            "by_reason": by_reason,
        }

        for name, tot in by_class.items():
            pts = tot.get("real_points", 0)
            tot["joules_per_point"] = (
                tot["modeled_joules"] / pts if pts else 0.0)

        energy = {
            "modeled_watts": watts_now,
            "watts_window_s": WATTS_WINDOW_S,
            "by_class": by_class,
            "hints": jpw,
            "classes": {name: {"active_watts": c.active_watts,
                               "work_per_second": c.work_per_second,
                               "dispatch_overhead_s": c.dispatch_overhead_s}
                        for name, c in DEVICE_CLASSES.items()},
        }

        return {
            "totals": totals,           # lifetime; the rest is window-local
            "energy": energy,
            "bucketing": bucketing,
            "continuous": continuous,
            "stages": stages,
            "errors": errors,
            "requests": len(requests),
            "cache_hits": sum(1 for r in requests if r.cache_hit),
            "p50_latency_s": percentile(latencies, 50),
            "p99_latency_s": percentile(latencies, 99),
            "p50_queue_wait_s": percentile(waits, 50),
            "batches": len(batches),
            "mean_occupancy": (
                sum(b.occupancy for b in batches) / len(batches)
                if batches else 0.0),
            "mean_batch_size": (
                sum(b.size for b in batches) / len(batches)
                if batches else 0.0),
            "suspended_batches": suspended,
            "resumed_batches": resumed,
            "modeled_joules": sum(b.modeled_joules for b in batches),
            "joules_per_work": jpw,
            "by_executor": by_executor,
        }
