"""Deterministic fault injection for crash-safety tests.

The durability story (WAL, replication, failover) is only as credible as
the crashes it has been tested against.  Before this module those
crashes were hand-rolled: each test embedded its own subprocess script
with a bespoke kill window.  This harness replaces that with *named
injection points* compiled into the production code paths::

    from repro_torch.service import faults
    ...
    faults.at("wal.append.before_fsync")

An injection point is a no-op (one global read + ``None`` check) unless
a fault plan is active.  Plans come from two places:

- the ``REPRO_FAULT`` environment variable, parsed at import — this is
  how a *subprocess* under test is armed without code changes::

      REPRO_FAULT="wal.append.before_fsync=kill@3"

- :func:`activate` for in-process tests, paired with :func:`reset`.

Spec grammar (semicolon-separated rules)::

    point=action[@hit]
    action := kill | raise | delay:<seconds>
    hit    := 1-based hit count at which the fault fires (default 1)

Actions:

- ``kill``  — SIGKILL the *current process* (the subprocess under test).
  The harshest crash the OS can deliver; exactly what the WAL's
  admitted-means-durable contract must survive.
- ``raise`` — raise :class:`FaultInjected` at the point.  Exercises the
  error-path cleanup (e.g. torn-tail repair on append failure).
- ``delay:S`` — sleep ``S`` seconds at the point.  Widens race windows
  (e.g. ship-vs-compact) deterministically.

Determinism: the k-th hit of a named point is an exact program location,
so a given seed workload + spec reproduces the same crash every run.
``REPRO_FAULT_SEED`` seeds the RNG used only for the optional
``delay:min..max`` jitter form, keeping even jittered runs replayable.

Coverage accounting: every fired fault is recorded in-process
(:func:`coverage`) *and*, when ``REPRO_FAULT_LEDGER`` names a file,
appended to that file with an fsync *before* the action executes — so a
``kill`` fault still leaves proof it fired, and the crash-matrix test
can assert every point in :data:`POINTS` was exercised.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

__all__ = [
    "POINTS",
    "FaultInjected",
    "FaultPlan",
    "at",
    "activate",
    "reset",
    "active_plan",
    "hits",
    "coverage",
    "read_ledger",
    "parse_spec",
]

# Canonical injection points.  Production code may only call
# ``faults.at()`` with a name listed here; the crash matrix sweeps this
# tuple and its coverage assertion keeps the two in lockstep.
POINTS = (
    # WAL: the admitted-means-durable boundary.
    "wal.append.before_fsync",      # frame written, not yet fsync'd
    "wal.append.after_fsync",       # durable, caller not yet acked
    "wal.mark_consumed.before_append",  # result delivered, consume not logged
    "wal.compact.before_unlink",    # segment chosen, file not yet removed
    # Rolling restart: predecessor drained, successor not yet live.
    "service.handover.before_successor",
)

_ENV_SPEC = "REPRO_FAULT"
_ENV_SEED = "REPRO_FAULT_SEED"
_ENV_LEDGER = "REPRO_FAULT_LEDGER"


class FaultInjected(RuntimeError):
    """Raised by an armed injection point with action ``raise``."""

    def __init__(self, point: str, hit: int) -> None:
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


@dataclass
class _Rule:
    point: str
    action: str                    # "kill" | "raise" | "delay"
    at_hit: int = 1                # 1-based hit count that fires
    delay_s: float = 0.0
    delay_max_s: Optional[float] = None   # delay jitter upper bound
    fired: int = 0
    last_delay_s: float = 0.0             # the delay actually slept


def parse_spec(spec: str) -> List[_Rule]:
    """Parse a ``REPRO_FAULT`` spec string into rules.

    Raises ``ValueError`` on malformed specs or unknown points — an
    armed-but-misspelled fault that silently never fires is worse than
    a loud failure.
    """
    rules: List[_Rule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"fault rule {part!r} missing '=': "
                             "expected point=action[@hit]")
        point, action = part.split("=", 1)
        point = point.strip()
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"known: {', '.join(POINTS)}")
        at_hit = 1
        if "@" in action:
            action, hit_s = action.rsplit("@", 1)
            try:
                at_hit = int(hit_s)
            except ValueError:
                raise ValueError(f"fault rule {part!r}: bad hit {hit_s!r}")
            if at_hit < 1:
                raise ValueError(f"fault rule {part!r}: hit must be >= 1")
        action = action.strip()
        delay_s = 0.0
        delay_max: Optional[float] = None
        if action.startswith("delay:"):
            window = action[len("delay:"):]
            action = "delay"
            if ".." in window:
                lo_s, hi_s = window.split("..", 1)
                delay_s, delay_max = float(lo_s), float(hi_s)
                if delay_max < delay_s:
                    raise ValueError(f"fault rule {part!r}: "
                                     "delay window inverted")
            else:
                delay_s = float(window)
            if delay_s < 0:
                raise ValueError(f"fault rule {part!r}: negative delay")
        if action not in ("kill", "raise", "delay"):
            raise ValueError(f"fault rule {part!r}: unknown action "
                             f"{action!r} (kill|raise|delay:<s>)")
        rules.append(_Rule(point=point, action=action, at_hit=at_hit,
                           delay_s=delay_s, delay_max_s=delay_max))
    return rules


@dataclass
class FaultPlan:
    """An armed set of rules plus the hit/coverage ledger."""

    rules: Dict[str, List[_Rule]] = field(default_factory=dict)
    seed: Optional[int] = None
    ledger_path: Optional[str] = None
    hits: Dict[str, int] = field(default_factory=dict)
    fired: Set[str] = field(default_factory=set)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._rng = random.Random(self.seed if self.seed is not None
                                  else 0xFA17)

    def hit(self, point: str) -> None:
        with self._lock:
            n = self.hits.get(point, 0) + 1
            self.hits[point] = n
            rule = None
            for cand in self.rules.get(point, ()):
                if n == cand.at_hit:
                    rule = cand
                    break
            if rule is None:
                return
            rule.fired += 1
            self.fired.add(point)
            delay = rule.delay_s
            if rule.delay_max_s is not None:
                delay = self._rng.uniform(rule.delay_s, rule.delay_max_s)
            rule.last_delay_s = delay
        # Ledger write happens *before* the action: a kill fault must
        # leave proof it fired for the parent's coverage accounting.
        self._ledger(point, rule.action, n)
        if rule.action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)         # never reached; belt for slow delivery
        elif rule.action == "raise":
            raise FaultInjected(point, n)
        elif rule.action == "delay":
            time.sleep(delay)

    def _ledger(self, point: str, action: str, hit: int) -> None:
        if not self.ledger_path:
            return
        line = f"{point} {action} {hit} {os.getpid()}\n".encode()
        try:
            fd = os.open(self.ledger_path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, line)
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass


_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()


def at(point: str) -> None:
    """Injection point.  No-op unless a plan is armed."""
    plan = _PLAN
    if plan is None:
        return
    plan.hit(point)


def activate(spec: str, *, seed: Optional[int] = None,
             ledger: Optional[str] = None) -> FaultPlan:
    """Arm a fault plan programmatically (tests).  Returns the plan."""
    global _PLAN
    rules = parse_spec(spec)
    plan = FaultPlan(seed=seed, ledger_path=ledger)
    for rule in rules:
        plan.rules.setdefault(rule.point, []).append(rule)
    with _PLAN_LOCK:
        _PLAN = plan
    return plan


def reset() -> None:
    """Disarm: injection points become no-ops again."""
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def hits() -> Dict[str, int]:
    """Hit counters of the active plan ({} when disarmed)."""
    plan = _PLAN
    return dict(plan.hits) if plan is not None else {}


def coverage() -> Set[str]:
    """Points that have *fired* (not merely been passed) in-process."""
    plan = _PLAN
    return set(plan.fired) if plan is not None else set()


def read_ledger(path: str) -> List[Dict[str, object]]:
    """Parse a ledger file written by (possibly killed) subprocesses."""
    out: List[Dict[str, object]] = []
    try:
        with open(path, "r") as fh:
            for line in fh:
                parts = line.split()
                if len(parts) != 4:
                    continue
                out.append({"point": parts[0], "action": parts[1],
                            "hit": int(parts[2]), "pid": int(parts[3])})
    except OSError:
        pass
    return out


def _install_from_env() -> None:
    spec = os.environ.get(_ENV_SPEC)
    if not spec:
        return
    seed_s = os.environ.get(_ENV_SEED)
    seed = int(seed_s) if seed_s else None
    activate(spec, seed=seed, ledger=os.environ.get(_ENV_LEDGER))


_install_from_env()
