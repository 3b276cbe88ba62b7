"""Preemption handling — the activity-lifecycle contract at cluster scale.

Paper: the Android OS may suspend the activity at any moment; jobs must
terminate "timely" (a few seconds) and release accelerator resources in an
ordered manner, and a *partial wake lock* keeps the CPU running while the
screen is allowed to turn off.

Cluster translation:
- SIGTERM/SIGINT (preemption notice from the scheduler) -> cancel the shared
  :class:`CancellationToken` with reason PREEMPTION; the training/clustering
  loop observes it at the next step boundary, writes a checkpoint, marks the
  job SUSPENDED and exits cleanly;
- :class:`HoldAlive` is the wake-lock analogue: while held, the job renews
  its heartbeat in the job store so the recovery sweep of other launchers
  never mistakes a live-but-slow job for an orphan.
"""

from __future__ import annotations

import signal
import threading
import time
from types import FrameType
from typing import Optional

from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.core.jobs import JobStore


class PreemptionGuard:
    """Routes SIGTERM/SIGINT into cooperative cancellation.

    Second signal while already cancelling re-raises the default behaviour
    (the paper's 'app would be reported not responding' deadline, inverted:
    we give the operator a hard-exit escape hatch).
    """

    def __init__(self, token: CancellationToken,
                 signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        self.token = token
        self.signals = signals
        self._old = {}
        self._fired = False

    def _handler(self, signum: int, frame: Optional[FrameType]) -> None:
        if self._fired:
            # restore + re-raise: hard exit on the second signal
            signal.signal(signum, self._old.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self._fired = True
        self.token.cancel(CancelReason.PREEMPTION)

    def __enter__(self) -> "PreemptionGuard":
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()


class HoldAlive:
    """Wake-lock analogue: heartbeat the job store while the job computes."""

    def __init__(self, store: JobStore, job_id: int,
                 interval: float = 5.0) -> None:
        self.store = store
        self.job_id = job_id
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.store.report_progress(self.job_id)

    def __enter__(self) -> "HoldAlive":
        self.store.report_progress(self.job_id)  # immediate first beat
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
