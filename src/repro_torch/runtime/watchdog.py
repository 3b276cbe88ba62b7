"""Step-time watchdog — straggler mitigation at the job level.

At pod scale a single slow host (thermal throttling, failing HBM, a noisy
neighbor) stretches every synchronous step.  The watchdog tracks a robust
running estimate of step time; when the *current* step exceeds
``factor x median`` it fires a callback — by default flagging the job so the
controller can checkpoint and reschedule (cancel with reason WATCHDOG),
mirroring the paper's requirement that a stuck computation must never block
the UI thread for more than a few seconds.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Callable, List, Optional


class StepWatchdog:
    def __init__(
        self,
        on_straggler: Callable[[float, float], None],
        *,
        factor: float = 3.0,
        min_samples: int = 5,
        poll_interval: float = 0.05,
    ) -> None:
        self.on_straggler = on_straggler
        self.factor = factor
        self.min_samples = min_samples
        self.poll_interval = poll_interval
        self._durations: List[float] = []
        self._step_start: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._fired_for_current = False
        self._thread: Optional[threading.Thread] = None
        self.straggler_events = 0

    # -- step instrumentation (called from the training loop) ---------------

    def step_begin(self) -> None:
        with self._lock:
            self._step_start = time.monotonic()
            self._fired_for_current = False

    def step_end(self) -> None:
        with self._lock:
            if self._step_start is not None:
                self._durations.append(time.monotonic() - self._step_start)
                if len(self._durations) > 256:
                    self._durations = self._durations[-128:]
            self._step_start = None

    @property
    def median(self) -> Optional[float]:
        with self._lock:
            if len(self._durations) < self.min_samples:
                return None
            return statistics.median(self._durations)

    # -- monitor thread -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            med = self.median
            with self._lock:
                start = self._step_start
                fired = self._fired_for_current
            if med is None or start is None or fired:
                continue
            elapsed = time.monotonic() - start
            if elapsed > self.factor * med:
                with self._lock:
                    self._fired_for_current = True
                    self.straggler_events += 1
                self.on_straggler(elapsed, med)

    def __enter__(self) -> "StepWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
