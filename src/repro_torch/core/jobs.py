"""Persistent deferred jobs — the WorkManager analogue.

Paper §II.A: jobs are submitted to Android's WorkManager, run as deferred
background tasks marked "foreground service" (exempt from doze/battery
policies), survive app restarts and device reboots, and the single activity
reads progress back out of the store when reattached.

Cluster translation: a launcher process can be killed/preempted at any time;
the job store is the durable source of truth.  On restart the launcher:

1. marks any job left RUNNING by a dead process as SUSPENDED (the process
   crashed mid-step — its heartbeat is stale);
2. resumes SUSPENDED jobs from their last checkpoint (step counter, RNG key,
   optimizer state all live in the checkpoint; the data pipeline replays from
   the step counter).

SQLite is used for the store — the same tool the paper used for its power
analysis — in WAL mode so progress heartbeats from a worker thread never
block the reader (the paper's activity reattach path).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional


class JobState(str, enum.Enum):
    ENQUEUED = "ENQUEUED"
    RUNNING = "RUNNING"
    SUSPENDED = "SUSPENDED"   # preempted / crashed; resumable from checkpoint
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    @property
    def terminal(self) -> bool:
        return self in (JobState.SUCCEEDED, JobState.FAILED, JobState.CANCELLED)


@dataclasses.dataclass
class Job:
    job_id: int
    kind: str
    params: Dict[str, Any]
    state: JobState
    step: int
    progress: Dict[str, Any]
    checkpoint_path: Optional[str]
    owner_pid: Optional[int]
    heartbeat: float
    created: float
    updated: float


_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id INTEGER PRIMARY KEY AUTOINCREMENT,
    kind TEXT NOT NULL,
    params TEXT NOT NULL,
    state TEXT NOT NULL,
    step INTEGER NOT NULL DEFAULT 0,
    progress TEXT NOT NULL DEFAULT '{}',
    checkpoint_path TEXT,
    owner_pid INTEGER,
    heartbeat REAL NOT NULL DEFAULT 0,
    created REAL NOT NULL,
    updated REAL NOT NULL
);
"""


class JobStore:
    """Durable job queue + progress store (thread-safe)."""

    def __init__(self, path: str, heartbeat_timeout: float = 60.0) -> None:
        self.path = path
        self.heartbeat_timeout = heartbeat_timeout
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(_SCHEMA)
        self._conn.commit()

    # -- lifecycle ---------------------------------------------------------

    def enqueue(self, kind: str, params: Dict[str, Any]) -> int:
        now = time.time()
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO jobs (kind, params, state, created, updated)"
                " VALUES (?, ?, ?, ?, ?)",
                (kind, json.dumps(params), JobState.ENQUEUED.value, now, now),
            )
            self._conn.commit()
            return int(cur.lastrowid)

    def claim_next(self, kind: Optional[str] = None) -> Optional[Job]:
        """Atomically claim the oldest runnable job (ENQUEUED or SUSPENDED)."""
        now = time.time()
        with self._lock:
            q = (
                "SELECT job_id FROM jobs WHERE state IN (?, ?)"
                + (" AND kind = ?" if kind else "")
                + " ORDER BY job_id LIMIT 1"
            )
            args: List[Any] = [JobState.ENQUEUED.value, JobState.SUSPENDED.value]
            if kind:
                args.append(kind)
            row = self._conn.execute(q, args).fetchone()
            if row is None:
                return None
            # state guard + rowcount: another process may have claimed it
            # between our SELECT and UPDATE (the store is shared on disk)
            cur = self._conn.execute(
                "UPDATE jobs SET state=?, owner_pid=?, heartbeat=?, updated=?"
                " WHERE job_id=? AND state IN (?, ?)",
                (JobState.RUNNING.value, os.getpid(), now, now, row[0],
                 JobState.ENQUEUED.value, JobState.SUSPENDED.value),
            )
            self._conn.commit()
            if cur.rowcount != 1:
                return None
        return self.get(int(row[0]))

    def claim(self, job_id: int) -> Optional[Job]:
        """Atomically claim a *specific* runnable job (service batches enqueue
        and immediately claim their own record; resume claims by id)."""
        now = time.time()
        with self._lock:
            # single guarded UPDATE: atomic against concurrent claimers in
            # other processes sharing the store
            cur = self._conn.execute(
                "UPDATE jobs SET state=?, owner_pid=?, heartbeat=?, updated=?"
                " WHERE job_id=? AND state IN (?, ?)",
                (JobState.RUNNING.value, os.getpid(), now, now, job_id,
                 JobState.ENQUEUED.value, JobState.SUSPENDED.value),
            )
            self._conn.commit()
            if cur.rowcount != 1:
                return None
        return self.get(job_id)

    def report_progress(
        self,
        job_id: int,
        *,
        step: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        **info: Any,
    ) -> None:
        """Heartbeat + progress (the activity's progress readout feeds on this)."""
        now = time.time()
        with self._lock:
            sets = ["heartbeat=?", "updated=?"]
            args: List[Any] = [now, now]
            if step is not None:
                sets.append("step=?")
                args.append(step)
            if checkpoint_path is not None:
                sets.append("checkpoint_path=?")
                args.append(checkpoint_path)
            if info:
                old = self._conn.execute(
                    "SELECT progress FROM jobs WHERE job_id=?", (job_id,)
                ).fetchone()
                merged = json.loads(old[0]) if old else {}
                merged.update(info)
                sets.append("progress=?")
                args.append(json.dumps(merged))
            args.append(job_id)
            self._conn.execute(
                f"UPDATE jobs SET {', '.join(sets)} WHERE job_id=?", args
            )
            self._conn.commit()

    def transition(self, job_id: int, state: JobState) -> None:
        now = time.time()
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET state=?, updated=? WHERE job_id=?",
                (state.value, now, job_id),
            )
            self._conn.commit()

    # -- recovery ------------------------------------------------------------

    def recover_orphans(self) -> List[int]:
        """RUNNING jobs whose owner is dead / heartbeat stale -> SUSPENDED.

        Called by a freshly started launcher — the paper's "activity searches
        for a previously submitted data mining job" reattach step.
        """
        now = time.time()
        orphans: List[int] = []
        with self._lock:
            rows = self._conn.execute(
                "SELECT job_id, owner_pid, heartbeat FROM jobs WHERE state=?",
                (JobState.RUNNING.value,),
            ).fetchall()
            for job_id, pid, hb in rows:
                dead = pid is None or not _pid_alive(int(pid))
                stale = (now - float(hb)) > self.heartbeat_timeout
                if dead or stale:
                    self._conn.execute(
                        "UPDATE jobs SET state=?, updated=? WHERE job_id=?",
                        (JobState.SUSPENDED.value, now, job_id),
                    )
                    orphans.append(int(job_id))
            self._conn.commit()
        return orphans

    # -- queries ---------------------------------------------------------------

    def get(self, job_id: int) -> Optional[Job]:
        with self._lock:
            row = self._conn.execute(
                "SELECT job_id, kind, params, state, step, progress,"
                " checkpoint_path, owner_pid, heartbeat, created, updated"
                " FROM jobs WHERE job_id=?",
                (job_id,),
            ).fetchone()
        if row is None:
            return None
        return Job(
            job_id=row[0],
            kind=row[1],
            params=json.loads(row[2]),
            state=JobState(row[3]),
            step=row[4],
            progress=json.loads(row[5]),
            checkpoint_path=row[6],
            owner_pid=row[7],
            heartbeat=row[8],
            created=row[9],
            updated=row[10],
        )

    def list_jobs(self, state: Optional[JobState] = None) -> List[Job]:
        with self._lock:
            if state is None:
                rows = self._conn.execute(
                    "SELECT job_id FROM jobs ORDER BY job_id"
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT job_id FROM jobs WHERE state=? ORDER BY job_id",
                    (state.value,),
                ).fetchall()
        return [j for (i,) in rows if (j := self.get(int(i))) is not None]

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True
