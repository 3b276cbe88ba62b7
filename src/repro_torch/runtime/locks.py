"""Reentrant writer-preferred reader/writer lock.

Direct port of the synchronization design in the paper (§II.A):

    "We use a self implemented reentrant writer preferred RW lock. [...] As
    the lock prefers the writers, from the moment a writer is waiting, all
    new readers have to queue up. After the readers, that already have
    acquired the lock when the writer arrived, have released the lock again,
    the writer can change the value of the flag. [...] After the writer has
    released the writer lock, all waiting readers see the new value."

In the paper the lock guards (a) the load state of the dynamically loaded
OpenCL library and (b) the cooperative abort flag polled between kernel
executions.  Here it guards (a) backend load state and (b) the cancellation
token polled between kernel launches (see :mod:`repro_torch.core.cancellation`).

Properties implemented (and asserted in tests/test_locks.py):

- multiple concurrent readers;
- writer exclusion (no readers or other writers while held);
- *writer preference*: once a writer is waiting, newly arriving readers block
  until the writer has acquired and released;
- *reentrancy*: a thread may re-acquire a lock it already holds (read-in-read,
  write-in-write, and read-in-write downgrade-style nesting);
- a thread holding the write lock may take the read lock without deadlock.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator


class RWLock:
    """Reentrant writer-preferred reader/writer lock."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        # per-thread read recursion counts (thread id -> count)
        self._readers: Dict[int, int] = {}
        self._writer: int | None = None  # thread id of current writer
        self._writer_recursion = 0
        self._writers_waiting = 0

    # -- introspection helpers (used by tests and the watchdog) ------------

    @property
    def readers(self) -> int:
        with self._cond:
            return sum(1 for c in self._readers.values() if c > 0)

    @property
    def writer_active(self) -> bool:
        with self._cond:
            return self._writer is not None

    @property
    def writers_waiting(self) -> int:
        with self._cond:
            return self._writers_waiting

    # -- read side ----------------------------------------------------------

    def acquire_read(self, timeout: float | None = None) -> bool:
        me = threading.get_ident()
        with self._cond:
            # Reentrant fast paths: already a reader, or we ARE the writer
            # (a writer may read its own protected state).
            if self._readers.get(me, 0) > 0 or self._writer == me:
                self._readers[me] = self._readers.get(me, 0) + 1
                return True
            # Writer preference: block while a writer is active OR waiting.
            ok = self._cond.wait_for(
                lambda: self._writer is None and self._writers_waiting == 0,
                timeout=timeout,
            )
            if not ok:
                return False
            self._readers[me] = 1
            return True

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            count = self._readers.get(me, 0)
            if count <= 0:
                raise RuntimeError("release_read without matching acquire_read")
            if count == 1:
                del self._readers[me]
            else:
                self._readers[me] = count - 1
            self._cond.notify_all()

    # -- write side ----------------------------------------------------------

    def acquire_write(self, timeout: float | None = None) -> bool:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:  # write-in-write reentrancy
                self._writer_recursion += 1
                return True
            self._writers_waiting += 1
            try:
                # Wait until no other writer and no reader other than us holds it.
                def _free() -> bool:
                    others_reading = any(
                        tid != me and c > 0 for tid, c in self._readers.items()
                    )
                    return self._writer is None and not others_reading

                ok = self._cond.wait_for(_free, timeout=timeout)
                if not ok:
                    return False
                self._writer = me
                self._writer_recursion = 1
                return True
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer != me:
                raise RuntimeError("release_write by non-owning thread")
            self._writer_recursion -= 1
            if self._writer_recursion == 0:
                self._writer = None
                self._cond.notify_all()

    # -- context managers -----------------------------------------------------

    @contextmanager
    def read(self) -> Iterator[None]:
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self) -> Iterator[None]:
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
