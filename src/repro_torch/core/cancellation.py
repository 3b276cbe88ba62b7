"""Cooperative cancellation — the paper's abort-flag protocol, distributed.

Paper §II.A: long-running jobs must stop "timely" when the user presses a
button, but a kernel in flight cannot be interrupted — so every
implementation "has to test from time to time a flag and check if they should
abort immediately.  For the implementations that use the GPU, the flag is
tested between OpenCL kernel executions.  The flag is accessed using the
reader lock of the RW lock.  To terminate the calculations prematurely, a
special method acquires the writer lock."

GPU translation: a launched CUDA kernel is uninterruptible the same way an
OpenCL kernel launch is, so the token is polled **between steps** (training
steps, clustering iterations, DBSCAN cluster expansions).  Readers are the
worker loops; the writer is whoever cancels (a signal handler, a watchdog, an
operator RPC).  Writer preference guarantees the flag flips as soon as the
in-flight step returns, no matter how many reader polls are queued.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, List, Optional

from repro_torch.runtime.locks import RWLock


class CancelReason(enum.Enum):
    NONE = "none"
    USER = "user"                # paper: the button in the app
    PREEMPTION = "preemption"    # paper: activity suspended / OS doze
    WATCHDOG = "watchdog"        # straggler mitigation
    ERROR = "error"


class CancellationToken:
    """Abort flag guarded by a writer-preferred reentrant RW lock."""

    def __init__(self) -> None:
        self._lock = RWLock()
        self._cancelled = False
        self._reason = CancelReason.NONE
        self._cancelled_at: Optional[float] = None
        self._callbacks: List[Callable[[CancelReason], None]] = []

    # -- reader side (polled between kernel executions / steps) -------------

    def cancelled(self) -> bool:
        with self._lock.read():
            return self._cancelled

    @property
    def reason(self) -> CancelReason:
        with self._lock.read():
            return self._reason

    def raise_if_cancelled(self) -> None:
        with self._lock.read():
            if self._cancelled:
                raise JobCancelled(self._reason)

    # -- writer side ----------------------------------------------------------

    def cancel(self, reason: CancelReason = CancelReason.USER) -> None:
        with self._lock.write():
            if self._cancelled:
                return
            self._cancelled = True
            self._reason = reason
            self._cancelled_at = time.monotonic()
            callbacks = list(self._callbacks)
        for cb in callbacks:  # outside the lock: callbacks may re-enter
            cb(reason)

    def reset(self) -> None:
        with self._lock.write():
            self._cancelled = False
            self._reason = CancelReason.NONE
            self._cancelled_at = None

    def on_cancel(self, cb: Callable[[CancelReason], None]) -> None:
        with self._lock.write():
            self._callbacks.append(cb)

    @property
    def latency(self) -> Optional[float]:
        """Seconds since cancel() was called (None if not cancelled)."""
        with self._lock.read():
            if self._cancelled_at is None:
                return None
            return time.monotonic() - self._cancelled_at


class JobCancelled(Exception):
    def __init__(self, reason: CancelReason) -> None:
        super().__init__(f"job cancelled: {reason.value}")
        self.reason = reason


def cancel_after(token: CancellationToken, seconds: float,
                 reason: CancelReason = CancelReason.USER) -> threading.Timer:
    """Arm a timer that cancels the token (used in tests and examples)."""
    t = threading.Timer(seconds, token.cancel, kwargs={"reason": reason})
    t.daemon = True
    t.start()
    return t
