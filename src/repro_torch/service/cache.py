"""Content-hash result cache: repeated datasets skip compute entirely.

Keyed by SHA-256 of (algorithm, canonical params, data shape/dtype/bytes),
so two tenants submitting the same dataset with the same parameters share
one computation — the paper's app recomputes from scratch on every run;
a service must not.  LRU-bounded by entry count; thread-safe.

With ``spill_dir`` set, entries also persist to disk beside the checkpoint
store: every put writes an atomic ``.npz`` (arrays) + JSON (scalars)
snapshot, and a memory miss falls back to the spill file — so a restarted
service answers repeat queries from a warm cache instead of recomputing,
the same restart story the job checkpoints give in-flight batches.  Spill
files older than ``ttl_s`` are treated as absent and unlinked lazily;
memory-LRU eviction does NOT remove the spill file (disk is the larger,
slower tier).  Disk eviction is TTL plus — with ``max_disk_bytes`` set —
an LRU size bound: when the spill dir grows past the bound, a background
sweep unlinks the least-recently-used files (mtime order; disk hits
touch their file) until it fits again, so a long-lived worker's spill
tier cannot grow without limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.service.queue import canonical_params

_SCALARS_LEAF = "__scalars__"


def content_key(algo: str, params: Dict[str, Any], data: np.ndarray) -> str:
    data = np.ascontiguousarray(data)
    h = hashlib.sha256()
    h.update(algo.encode())
    h.update(repr(canonical_params(algo, params)).encode())
    # per-item params that change the result (e.g. kmeans seed) must still
    # differentiate cache entries even though they don't split batches
    h.update(repr(sorted(
        (k, v) for k, v in params.items()
        if k not in dict(canonical_params(algo, params))
    )).encode())
    h.update(str(data.shape).encode())
    h.update(str(data.dtype).encode())
    h.update(data.tobytes())
    return h.hexdigest()


def _copy_result(result: Dict[str, Any]) -> Dict[str, Any]:
    """Array values are copied: a tenant mutating its returned labels must
    never corrupt the cached entry another tenant will be served."""
    return {
        k: (v.copy() if isinstance(v, np.ndarray) else v)
        for k, v in result.items()
    }


class ResultCache:
    """LRU over result dicts (labels + scalars), keyed by content hash.

    ``spill_dir`` enables the disk tier; ``ttl_s`` bounds a spilled entry's
    age (None = spilled entries never expire); ``max_disk_bytes`` bounds
    the spill dir's total size with an LRU sweep (None = unbounded).
    """

    def __init__(self, max_entries: int = 256, *,
                 spill_dir: Optional[str] = None,
                 ttl_s: Optional[float] = None,
                 max_disk_bytes: Optional[int] = None) -> None:
        self.max_entries = max_entries
        self.spill_dir = spill_dir
        self.ttl_s = ttl_s
        self.max_disk_bytes = (None if max_disk_bytes is None
                               else max(0, int(max_disk_bytes)))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.disk_evictions = 0
        # at most one background sweep in flight; spills that find it busy
        # skip — the running sweep re-reads the dir and covers them
        self._sweeping = threading.Lock()

    # -- disk tier -----------------------------------------------------------

    def _spill_path(self, key: str) -> str:
        assert self.spill_dir is not None
        # keys are content hashes already, but callers may use free-form
        # keys in tests — re-hash for a uniformly filesystem-safe name
        name = hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self.spill_dir, f"{name}.npz")

    def _spill(self, key: str, result: Dict[str, Any]) -> None:
        """Atomic write (tmp + rename): a killed writer never leaves a
        half-entry a restarted service would trust.  Best-effort: spill
        I/O failure (disk full, unwritable workdir) must never propagate
        into the serving path — the entry just stays memory-only."""
        try:
            os.makedirs(self.spill_dir, exist_ok=True)
        except OSError:
            return
        path = self._spill_path(key)
        arrays = {k: v for k, v in result.items()
                  if isinstance(v, np.ndarray)}
        scalars = {k: v for k, v in result.items()
                   if not isinstance(v, np.ndarray)}
        try:
            payload = json.dumps(scalars)
        except TypeError:
            return                      # non-JSON scalar: memory-only entry
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **{_SCALARS_LEAF: np.asarray(payload)}, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._maybe_sweep()

    # -- disk size bound -----------------------------------------------------

    def _maybe_sweep(self) -> None:
        """Kick a background LRU sweep of the spill dir (non-blocking)."""
        if self.max_disk_bytes is None or self.spill_dir is None:
            return
        if not self._sweeping.acquire(blocking=False):
            return                       # a sweep is already running
        t = threading.Thread(target=self._sweep_and_release,
                             name="cache-disk-sweep", daemon=True)
        t.start()

    def _sweep_and_release(self) -> None:
        try:
            self.sweep_disk()
        finally:
            self._sweeping.release()

    def sweep_disk(self) -> int:
        """Unlink least-recently-used spill files until the tier fits
        ``max_disk_bytes``; returns the number evicted.  Disk *hits*
        touch their file's mtime (see :meth:`_load_spilled`), so mtime
        order IS recency order.  Safe to call concurrently with serving:
        a racing get simply misses to recompute."""
        if self.max_disk_bytes is None or self.spill_dir is None:
            return 0
        try:
            with os.scandir(self.spill_dir) as it:
                files = [(e.path, e.stat().st_mtime, e.stat().st_size)
                         for e in it
                         if e.is_file() and e.name.endswith(".npz")]
        except OSError:
            return 0
        total = sum(size for _, _, size in files)
        if total <= self.max_disk_bytes:
            return 0
        evicted = 0
        for path, _mtime, size in sorted(files, key=lambda f: f[1]):
            if total <= self.max_disk_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            evicted += 1
        with self._lock:
            self.disk_evictions += evicted
        return evicted

    def disk_usage(self) -> Dict[str, int]:
        """Spill-tier footprint (files, bytes); zeros when disabled."""
        if self.spill_dir is None:
            return {"disk_files": 0, "disk_bytes": 0}
        files = total = 0
        try:
            with os.scandir(self.spill_dir) as it:
                for e in it:
                    if e.is_file() and e.name.endswith(".npz"):
                        files += 1
                        total += e.stat().st_size
        except OSError:
            pass
        return {"disk_files": files, "disk_bytes": total}

    def _load_spilled(self, key: str) -> Optional[Dict[str, Any]]:
        path = self._spill_path(key)
        try:
            age = time.time() - os.path.getmtime(path)
        except OSError:
            return None
        if self.ttl_s is not None and age > self.ttl_s:
            try:
                os.unlink(path)         # expired: lazily collected
            except OSError:
                pass
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                result: Dict[str, Any] = dict(
                    json.loads(str(z[_SCALARS_LEAF])))
                for name in z.files:
                    if name != _SCALARS_LEAF:
                        result[name] = z[name]
            try:
                # a disk hit refreshes recency, so the size-bound sweep
                # (mtime order) evicts cold entries, not popular ones
                os.utime(path)
            except OSError:
                pass
            return result
        except Exception:
            try:
                os.unlink(path)         # corrupt/truncated: drop it
            except OSError:
                pass
            return None

    # -- the cache API -------------------------------------------------------

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return _copy_result(entry)
        if self.spill_dir is not None and self.max_entries > 0:
            spilled = self._load_spilled(key)
            if spilled is not None:
                with self._lock:
                    self._insert(key, spilled)
                    self.hits += 1
                    self.disk_hits += 1
                return _copy_result(spilled)
        with self._lock:
            self.misses += 1
        return None

    def _insert(self, key: str, result: Dict[str, Any]) -> None:
        self._entries[key] = _copy_result(result)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def put(self, key: str, result: Dict[str, Any]) -> None:
        if self.max_entries <= 0:
            return
        with self._lock:
            self._insert(key, result)
        if self.spill_dir is not None:
            self._spill(key, result)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        usage = self.disk_usage()
        with self._lock:
            out = {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "disk_hits": self.disk_hits,
                "disk_evictions": self.disk_evictions,
            }
        out.update(usage)
        if self.max_disk_bytes is not None:
            out["max_disk_bytes"] = self.max_disk_bytes
        return out
