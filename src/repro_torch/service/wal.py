"""Durable admission log: a write-ahead log for admitted requests.

The rest of the durability story starts at the *batch*: a request is safe
once its batch job's step-0 checkpoint lands (see
:mod:`repro_torch.service.executor`).  This module closes the window before
that — the paper's activity can be killed between accepting work and
handing it to WorkManager, and so can this service between admission and
batching.  :class:`RequestLog` records every admitted request durably
*before* it enters the in-memory :class:`~repro_torch.service.queue.AdmissionQueue`,
so the contract becomes **admitted means durable**: a SIGKILL at any moment
loses nothing that the caller was told was accepted.

Design:

- **Append-only segments.**  Records append to ``wal-<seq>.log`` under the
  log root; when the active segment passes ``segment_bytes`` it is sealed
  (fsync + close) and a new one opens.  Two record types: ``ADMIT`` (the
  request payload — params/QoS as JSON, the data as raw ``.npy`` bytes)
  and ``CONSUME`` (entry ids whose batch job reached its step-0
  checkpoint, or that terminated without ever needing replay).
- **CRC-checked framing.**  Every record is ``magic | type | header_len |
  data_len | crc32(header+data)`` followed by the bytes.  A torn tail
  (killed mid-append) or a flipped bit invalidates the damaged record:
  replay keeps everything before it and skips the rest of that segment
  — later segments still replay (records are independent).
- **Batched fsync (group commit).**  Appends buffer under one lock and
  sync under another: a thread whose bytes were already covered by a
  concurrent fsync returns without issuing its own, so N submitting
  threads pay ~1 fsync, not N.
- **Compaction.**  A ``CONSUME`` record always appends *after* the
  ``ADMIT`` records it covers, so a consume marker can only reference
  admits in its own or an earlier segment.  Dropping the longest prefix
  of sealed segments whose admits are all consumed therefore never
  strands a live entry: every marker lost with the prefix pointed into
  the prefix.
- **Replay.**  :meth:`RequestLog.replay` returns the unconsumed ``ADMIT``
  records in admission order.  The service resubmits each through the
  normal front door (content-hash cache dedup makes replaying completed
  work free) and marks the old entry consumed once the resubmission is
  durable under a fresh entry — crash *during* recovery at worst replays
  twice (at-least-once), never zero times.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import re
import struct
import threading
import zlib
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.service import faults

try:                               # POSIX only; the lock degrades to a
    import fcntl                   # no-op where record locks don't exist
except ImportError:                # pragma: no cover - non-POSIX hosts
    fcntl = None

logger = logging.getLogger(__name__)

LOCK_FILENAME = "LOCK"


class WalLocked(RuntimeError):
    """Another *process* already owns this admission log.

    Two services appending the same segments would interleave frames and
    corrupt each other's records, so the log takes a POSIX record lock
    (``fcntl.lockf``) on ``<root>/LOCK`` for as long as it is open.  The
    error is structured: ``root`` is the contested log directory and
    ``holder_pid`` the owner recorded in the lockfile (best-effort — the
    kernel enforces the lock, the pid is diagnostics).

    The lock is per-process (POSIX semantics): sequential services inside
    one process hand over freely — same as the ``jobs.db`` assumption —
    while a second *process* gets this error instead of silent corruption.

    ``retry_after`` makes the error *retryable* for a fleet router: a
    takeover racing the victim's death (or two survivors racing each
    other) should back off and retry rather than fail — the lock clears
    the instant the owning process exits.
    """

    def __init__(self, message: str, *, root: str,
                 holder_pid: Optional[int] = None,
                 retry_after: float = 0.5) -> None:
        super().__init__(message)
        self.root = root
        self.holder_pid = holder_pid
        self.retry_after = retry_after

# record framing: magic u32 | type u8 | header_len u32 | data_len u64 |
# crc32(header+data) u32
_FRAME = struct.Struct("<IBIQI")
_MAGIC = 0x57414C31            # "WAL1"
_ADMIT = 1
_CONSUME = 2
_SEGMENT_RE = re.compile(r"^wal-(\d{8})\.log$")

# refuse to trust absurd lengths from a corrupt frame (the CRC would catch
# it anyway, but not before a giant allocation)
_MAX_HEADER = 1 << 20          # 1 MiB of JSON header
_MAX_DATA = 1 << 34            # 16 GiB of payload


@dataclasses.dataclass
class WalRecord:
    """One unconsumed admitted request, as replay returns it."""

    entry_id: int
    tenant: str
    algo: str
    data: np.ndarray
    params: Dict[str, Any]
    executor: Optional[str] = None
    priority: int = 1
    deadline: Optional[float] = None
    cache_key: Optional[str] = None
    # the request's trace id rides in the entry so recover() continues the
    # SAME trace across process death instead of minting a fresh one
    trace_id: Optional[str] = None


def _encode_data(data: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(data), allow_pickle=False)
    return buf.getvalue()


def _decode_data(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw), allow_pickle=False)


def _fsync_dir(path: str) -> None:
    """Make directory-entry changes (segment create/unlink/truncate)
    power-loss durable; fsyncing file *data* alone does not persist the
    name on ext4/XFS.  Best-effort on filesystems without O_DIRECTORY
    fsync support."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class RequestLog:
    """Append-only, segment-rotated, CRC-checked admission WAL.

    Thread-safe.  ``append_admit`` returns only after the record is
    fsynced (group commit amortises the sync across concurrent callers).
    Entry ids are monotonic across reopens: a restarted log continues
    where the dead process stopped.
    """

    def __init__(self, root: str, *, segment_bytes: int = 4 << 20) -> None:
        self.root = root
        self.segment_bytes = max(1, int(segment_bytes))
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()        # file position + index state
        self._sync_lock = threading.Lock()   # group-commit fsync
        self._file: Optional[io.BufferedWriter] = None
        self._seg_seq = 0
        # index rebuilt from disk at open, maintained on append:
        #   segment seq -> set of admit entry ids living in it
        self._seg_admits: Dict[int, Set[int]] = {}
        self._consumed: Set[int] = set()
        self._next_id = 1
        self._written = 0          # bytes appended to the active segment
        self._synced = 0           # bytes known fsynced in the active segment
        self.fsyncs = 0
        self.appended = 0          # ADMIT records written by this process
        self.compacted_segments = 0
        # telemetry tap: on_event(name, fields) after compactions (never
        # under the log lock, never raising into the append path)
        self.on_event = None
        self._lock_key: Optional[str] = None
        self._acquire_lock()
        self._open()

    def _notify(self, name: str, **fields: Any) -> None:
        cb = self.on_event
        if cb is None:
            return
        try:
            cb(name, fields)
        except Exception:
            logger.exception("wal on_event hook raised for %s", name)

    # -- cross-process exclusivity ----------------------------------------------

    # one OS-level record lock per root per PROCESS, refcounted across the
    # RequestLog instances of this process.  POSIX record locks have the
    # classic footgun that closing ANY fd for the locked file drops the
    # whole process's lock — so a second in-process log (sequential
    # services over one workdir, an inspection helper) must share the one
    # locked fd instead of opening its own, or its close() would silently
    # let another process in while the first log still appends.
    _proc_locks: Dict[str, List[Any]] = {}       # realpath -> [fd, refcount]
    _proc_locks_guard = threading.Lock()

    def _acquire_lock(self) -> None:
        """Take (or share) the single-writer lock on ``<root>/LOCK``.

        Raises :class:`WalLocked` when another *process* holds it.  Held
        for as long as any log of this process has the root open;
        :meth:`close` releases this instance's share (and process death
        releases everything — which is exactly what lets ``recover()``
        open a dead process's log).
        """
        if fcntl is None:          # pragma: no cover - non-POSIX hosts
            return
        key = os.path.realpath(self.root)
        with RequestLog._proc_locks_guard:
            entry = RequestLog._proc_locks.get(key)
            if entry is not None:
                entry[1] += 1
                self._lock_key = key
                return
            path = os.path.join(self.root, LOCK_FILENAME)
            fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.lockf(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                holder: Optional[int] = None
                try:
                    raw = os.pread(fd, 64, 0).split()
                    holder = int(raw[0]) if raw else None
                except (OSError, ValueError):
                    pass
                os.close(fd)
                raise WalLocked(
                    f"admission log {self.root!r} is already open for "
                    f"append in another process"
                    + (f" (pid {holder})" if holder else "")
                    + "; one writer per workdir — stop the other service "
                      "or use a different workdir",
                    root=self.root, holder_pid=holder) from None
            os.ftruncate(fd, 0)
            os.pwrite(fd, f"{os.getpid()}\n".encode(), 0)
            RequestLog._proc_locks[key] = [fd, 1]
            self._lock_key = key

    def _release_lock(self) -> None:
        if self._lock_key is None:
            return
        key, self._lock_key = self._lock_key, None
        with RequestLog._proc_locks_guard:
            entry = RequestLog._proc_locks.get(key)
            if entry is None:      # pragma: no cover - double release
                return
            entry[1] -= 1
            if entry[1] > 0:
                return             # another in-process log still holds it
            del RequestLog._proc_locks[key]
            fd = entry[0]
        try:
            if fcntl is not None:
                fcntl.lockf(fd, fcntl.LOCK_UN)
        except OSError:            # pragma: no cover - lock already gone
            pass
        finally:
            os.close(fd)

    # -- segments --------------------------------------------------------------

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.root, f"wal-{seq:08d}.log")

    def _segments(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = _SEGMENT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _open(self) -> None:
        """Rebuild the index from every segment, then open the tail for
        append (or start a fresh segment when the tail is full/absent)."""
        segs = self._segments()
        max_id = 0
        tail_valid_end = 0
        for seq in segs:
            admits: Set[int] = set()
            # index rebuild needs headers only — but the tail is about to
            # be appended to, so its valid_end must be CRC-verified (a
            # corrupt-but-length-complete record would otherwise strand
            # everything appended after it behind an unreadable frame)
            tail = seq == segs[-1]
            records, valid_end = self._scan(self._seg_path(seq),
                                            payloads=tail)
            if tail:
                tail_valid_end = valid_end
            for rec_type, header, _data in records:
                if rec_type == _ADMIT:
                    eid = int(header["entry_id"])
                    admits.add(eid)
                    max_id = max(max_id, eid)
                elif rec_type == _CONSUME:
                    for i in header["entry_ids"]:
                        self._consumed.add(int(i))
                        # compaction may have dropped the segment holding
                        # these admits while their markers survive in a
                        # later one — ids must never be reissued, or the
                        # stale markers would silently swallow new admits
                        # at replay
                        max_id = max(max_id, int(i))
            self._seg_admits[seq] = admits
        self._next_id = max_id + 1
        self._seg_seq = segs[-1] if segs else 1
        self._seg_admits.setdefault(self._seg_seq, set())
        path = self._seg_path(self._seg_seq)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size and tail_valid_end < size:
            # a torn tail (killed mid-append) must be cut before appending:
            # readers stop at the first bad frame, so bytes written after
            # it would be unreachable forever
            logger.warning("wal: truncating %s from %d to %d (torn tail)",
                           path, size, tail_valid_end)
            with open(path, "r+b") as f:
                f.truncate(tail_valid_end)
                f.flush()
                os.fsync(f.fileno())
            size = tail_valid_end
        if size >= self.segment_bytes:
            self._seg_seq += 1
            self._seg_admits.setdefault(self._seg_seq, set())
            path = self._seg_path(self._seg_seq)
            size = 0
        existed = os.path.exists(path)
        self._file = open(path, "ab")
        if not existed:
            _fsync_dir(self.root)   # the new name must survive power loss
        self._written = self._synced = size

    def _rotate_locked(self) -> None:
        """Seal the active segment and open the next (under ``_lock``).
        A failure opening the new segment leaves ``_file`` None with the
        sequence unchanged, so the next append lazily reopens the old
        (sealed but intact) segment instead of writing into limbo."""
        assert self._file is not None
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._file = None
        f = open(self._seg_path(self._seg_seq + 1), "ab")
        self._seg_seq += 1
        self._seg_admits.setdefault(self._seg_seq, set())
        self._file = f
        _fsync_dir(self.root)       # the new name must survive power loss
        self._written = self._synced = 0

    def _repair_tail_locked(self) -> None:
        """A failed record write may leave torn bytes (buffered or on
        disk) past the last committed offset; later appends would then
        sit behind an unreadable frame — fsync-acknowledged yet invisible
        to replay.  Cut the segment back to the last record boundary
        before any further append is allowed."""
        path = self._seg_path(self._seg_seq)
        good = self._written
        if self._file is not None:
            try:
                self._file.close()   # flushes whatever it can, then frees
            except OSError:
                pass
            self._file = None
        try:
            with open(path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
            self._file = open(path, "ab")
        except OSError:
            # device unusable: stay closed — the next append's lazy
            # reopen re-derives offsets from the on-disk size
            logger.exception("wal: failed to repair segment tail %s", path)
        self._synced = min(self._synced, good)

    # -- append ----------------------------------------------------------------

    def _append(self, rec_type: int, header: Dict[str, Any],
                data: bytes = b"", admit_id: Optional[int] = None) -> int:
        """Write one framed record; returns the segment that received it.
        Blocks until the bytes are fsynced (group commit).  ``admit_id``
        registers an ADMIT in the segment index under the same lock as
        the write — deferring it would let a concurrent rotation +
        compact() unlink a sealed segment whose live admit was not yet
        indexed."""
        hdr = json.dumps(header).encode()
        crc = zlib.crc32(hdr + data) & 0xFFFFFFFF
        frame = _FRAME.pack(_MAGIC, rec_type, len(hdr), len(data), crc)
        with self._lock:
            if self._file is None:
                # closed (service stop()): reopen the active segment — the
                # index is still in memory, only the fd (and the writer
                # lock) was released.  Re-acquiring may raise WalLocked if
                # another process took over the workdir in between; that
                # is the correct answer (this log must not append).
                if self._lock_key is None:
                    self._acquire_lock()
                path = self._seg_path(self._seg_seq)
                self._file = open(path, "ab")
                self._written = self._synced = os.path.getsize(path)
            if self._written >= self.segment_bytes:
                self._rotate_locked()
            try:
                self._file.write(frame)
                self._file.write(hdr)
                self._file.write(data)
            except BaseException:
                self._repair_tail_locked()
                raise
            self._written += len(frame) + len(hdr) + len(data)
            if admit_id is not None:
                self._seg_admits.setdefault(self._seg_seq,
                                            set()).add(admit_id)
                self.appended += 1
            end = (self._seg_seq, self._written)
        # crash window 1: the record is written but not yet durable — a
        # kill here must lose the record without corrupting the segment
        faults.at("wal.append.before_fsync")
        self._sync_to(end)
        # crash window 2: durable but the caller was never told — replay
        # must surface the entry (at-least-once, deduped by content hash)
        faults.at("wal.append.after_fsync")
        return end[0]

    def _sync_to(self, end: Tuple[int, int]) -> None:
        """Group commit: return once bytes up to ``end`` are durable.  A
        caller whose bytes a concurrent fsync already covered pays nothing."""
        seq, offset = end
        with self._sync_lock:
            with self._lock:
                if self._file is None:
                    return
                # a rotation seals (fsync + close) every earlier segment
                if self._seg_seq > seq or self._synced >= offset:
                    return
                self._file.flush()
                # dup: rotation may close the original fd mid-fsync
                fd = os.dup(self._file.fileno())
                covered_seq, covered = self._seg_seq, self._written
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            with self._lock:
                if self._seg_seq == covered_seq:
                    self._synced = max(self._synced, covered)
                self.fsyncs += 1

    def reserve_id(self) -> int:
        """Allocate the next entry id *without* writing anything.

        Lets a caller publish the id (e.g. in its in-flight table) before
        the record can possibly exist on disk, closing the window where a
        concurrent log reader sees the durable entry but no owner.
        """
        with self._lock:
            entry_id = self._next_id
            self._next_id += 1
            return entry_id

    def append_admit(self, tenant: str, algo: str, data: np.ndarray,
                     params: Dict[str, Any], *,
                     executor: Optional[str] = None,
                     priority: int = 1,
                     deadline: Optional[float] = None,
                     cache_key: Optional[str] = None,
                     entry_id: Optional[int] = None,
                     trace_id: Optional[str] = None) -> int:
        """Durably record one admitted request; returns its entry id
        (pass a :meth:`reserve_id` result to use a pre-published id)."""
        payload = _encode_data(np.asarray(data))
        if entry_id is None:
            entry_id = self.reserve_id()
        header = {
            "entry_id": entry_id,
            "tenant": tenant,
            "algo": algo,
            "params": dict(params),
            "executor": executor,
            "priority": int(priority),
            "deadline": deadline,
            "cache_key": cache_key,
            "trace_id": trace_id,
            "shape": list(np.shape(data)),
        }
        self._append(_ADMIT, header, payload, admit_id=entry_id)
        return entry_id

    def mark_consumed(self, entry_ids: Iterable[int],
                      job_id: Optional[int] = None) -> None:
        """Record that these admits no longer need replay (their batch job
        reached step-0, or they terminated before batching).  Idempotent;
        unknown ids are ignored at replay time."""
        with self._lock:
            fresh = [int(i) for i in entry_ids
                     if int(i) not in self._consumed]
        if not fresh:
            return
        # crash window: result delivered but the consume marker is not
        # durable — replay re-runs the entry and the content-hash cache
        # absorbs the duplicate
        faults.at("wal.mark_consumed.before_append")
        self._append(_CONSUME, {"entry_ids": fresh, "job_id": job_id})
        with self._lock:
            self._consumed.update(fresh)
            sealed = len(self._seg_admits) > 1
        if sealed:
            # opportunistic compaction: consuming may have just freed a
            # sealed prefix — without this, a long-running service would
            # only reclaim segments at the next restart's recover()
            self.compact()

    # -- read ------------------------------------------------------------------

    @staticmethod
    def _scan(path: str, payloads: bool = True,
              ) -> Tuple[List[Tuple[int, Dict[str, Any], bytes]], int]:
        """Parse every intact record of one segment, streaming.

        Returns ``(records, valid_end)`` where ``records`` is a list of
        ``(type, header, data)`` and ``valid_end`` the byte offset of the
        last intact record's end.  Parsing stops at the first torn or
        corrupt frame — the rest of the segment is untrusted (a crashed
        writer only ever damages the tail).

        ``payloads=False`` is the index mode: data bytes are seeked past
        instead of read (``data`` comes back empty), so scanning a large
        segment costs headers only.  CRCs are then verified only for
        records whose bytes were fully read (payload-free ones like
        CONSUME); ADMIT payload CRCs are re-verified by the
        ``payloads=True`` read that actually uses them.
        """
        try:
            f = open(path, "rb")
        except OSError:
            return [], 0
        records: List[Tuple[int, Dict[str, Any], bytes]] = []
        pos = 0
        with f:
            size = os.fstat(f.fileno()).st_size
            while pos + _FRAME.size <= size:
                head = f.read(_FRAME.size)
                if len(head) < _FRAME.size:
                    break
                magic, rec_type, hlen, dlen, crc = _FRAME.unpack(head)
                if (magic != _MAGIC or rec_type not in (_ADMIT, _CONSUME)
                        or hlen > _MAX_HEADER or dlen > _MAX_DATA):
                    logger.warning("wal: bad frame in %s at %d; "
                                   "dropping segment tail", path, pos)
                    break
                body_end = pos + _FRAME.size + hlen + dlen
                if body_end > size:
                    break                   # torn tail: incomplete append
                if payloads or dlen == 0:
                    body = f.read(hlen + dlen)
                    if zlib.crc32(body) & 0xFFFFFFFF != crc:
                        logger.warning("wal: crc mismatch in %s at %d; "
                                       "dropping segment tail", path, pos)
                        break
                    hdr_bytes, data = body[:hlen], body[hlen:]
                else:
                    hdr_bytes = f.read(hlen)
                    f.seek(dlen, os.SEEK_CUR)
                    data = b""
                try:
                    header = json.loads(hdr_bytes.decode())
                except ValueError:
                    logger.warning("wal: undecodable header in %s at %d",
                                   path, pos)
                    break
                records.append((rec_type, header, data))
                pos = body_end
        return records, pos

    def replay(self) -> List[WalRecord]:
        """Unconsumed admitted requests, oldest first.

        Reads from disk (not the in-memory index), so a log opened over a
        dead process's segments replays exactly what that process made
        durable.  Two passes: a header-only scan finds what is pending,
        then payloads are read only from segments that actually hold a
        pending admit — a mostly-consumed log replays without touching
        (or holding in memory) the consumed payload bytes.
        """
        with self._lock:
            if self._file is not None:
                self._file.flush()
            segs = self._segments()
        consumed: Set[int] = set()
        seg_admits: Dict[int, Set[int]] = {}
        for seq in segs:
            records, _valid_end = self._scan(self._seg_path(seq),
                                             payloads=False)
            for rec_type, header, _data in records:
                if rec_type == _CONSUME:
                    consumed.update(int(i) for i in header["entry_ids"])
                else:
                    seg_admits.setdefault(seq, set()).add(
                        int(header["entry_id"]))
        admits: "Dict[int, WalRecord]" = {}
        for seq in segs:
            if not seg_admits.get(seq, set()) - consumed:
                continue                    # nothing pending here
            records, _valid_end = self._scan(self._seg_path(seq))
            for rec_type, header, data in records:
                if rec_type != _ADMIT:
                    continue
                entry_id = int(header["entry_id"])
                if entry_id in consumed:
                    continue
                try:
                    arr = _decode_data(data)
                except Exception:
                    logger.warning("wal: entry %s payload undecodable; "
                                   "skipped", header.get("entry_id"))
                    continue
                admits[entry_id] = WalRecord(
                    entry_id=entry_id,
                    tenant=str(header["tenant"]),
                    algo=str(header["algo"]),
                    data=arr,
                    params=dict(header["params"]),
                    executor=header.get("executor"),
                    priority=int(header.get("priority", 1)),
                    deadline=header.get("deadline"),
                    cache_key=header.get("cache_key"),
                    trace_id=header.get("trace_id"),
                )
        return [admits[i] for i in sorted(admits)]

    # -- compaction ------------------------------------------------------------

    def compact(self) -> int:
        """Drop the longest prefix of sealed, fully-consumed segments.

        Safe because consume markers only ever point backwards: a marker
        deleted with the prefix covered an admit that is also in the
        prefix.  Returns the number of segments removed.
        """
        dropped = 0
        with self._lock:
            for seq in sorted(self._seg_admits):
                if seq == self._seg_seq:          # active segment: never
                    break
                admits = self._seg_admits[seq]
                if admits - self._consumed:
                    break                          # a live entry pins it
                # crash window: segment chosen for removal but still on
                # disk — a kill here leaves a fully-consumed segment that
                # the next open simply re-indexes and re-compacts
                faults.at("wal.compact.before_unlink")
                try:
                    os.unlink(self._seg_path(seq))
                except OSError:
                    break
                self._consumed -= admits
                del self._seg_admits[seq]
                dropped += 1
            self.compacted_segments += dropped
            remaining = len(self._seg_admits)
        if dropped:
            _fsync_dir(self.root)
            self._notify("wal_compaction", segments_dropped=dropped,
                         segments_remaining=remaining)
        return dropped

    # -- lifecycle / stats -------------------------------------------------------

    def _pending_locked(self) -> int:
        live: Set[int] = set()
        for admits in self._seg_admits.values():
            live |= admits
        return len(live - self._consumed)

    def pending(self) -> int:
        """Admitted-but-unconsumed entries across all segments."""
        with self._lock:
            return self._pending_locked()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "segments": len(self._seg_admits),
                "pending": self._pending_locked(),
                "consumed": len(self._consumed),
                "appended": self.appended,
                "fsyncs": self.fsyncs,
                "compacted_segments": self.compacted_segments,
                # replication watermark: highest entry id ever issued —
                # the shipper reports standby lag against this
                "last_entry_id": self._next_id - 1,
                "locked": self._lock_key is not None,
            }

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None
            # release the single-writer lock with the fd: a closed log
            # must not fence out a successor service over the workdir
            self._release_lock()

    def __enter__(self) -> "RequestLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
