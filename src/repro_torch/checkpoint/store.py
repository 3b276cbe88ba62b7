"""Sharded checkpoint store: atomic, checksummed, async, resumable.

The durability contract (WorkManager jobs survive reboots) requires that a
checkpoint directory is either complete and verified or invisible:

- leaves are written into ``<root>/tmp.<step>.<nonce>/`` and the directory is
  atomically renamed to ``<root>/step_<step>/`` only after every file and the
  manifest have been fsynced — a killed writer can never leave a
  half-checkpoint that a resuming job would trust;
- every leaf file carries a CRC32 in the manifest, verified on restore;
- :class:`AsyncCheckpointer` snapshots arrays to host memory at submit time
  and writes on a background thread, so the train loop only blocks for the
  device->host copy (and on the previous write when saves outpace I/O);
- restore takes a target ``device``: leaves come back as host numpy arrays,
  or as tensors on that device.

Format: one ``.npy`` per tree leaf, named by the flattened key path, plus
``manifest.json`` (shapes, dtypes, crcs, user metadata, format version).
Trees are nested dicts, lists and tuples; :func:`tree_flatten_with_path`
walks them in the reference package's order and names (dict keys sorted,
``None`` dropped, list indices as numbers), so a checkpoint written by
either package restores in the other.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1
_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree: Any) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a tree node, in flattening order."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    return list(enumerate(tree))


def _is_node(tree: Any) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_flatten_with_path(tree: Any, path: Tuple = ()
                           ) -> List[Tuple[Tuple, Any]]:
    """[(key path, leaf)] in the reference's order; ``None`` is no leaf."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(path, tree)]
    out: List[Tuple[Tuple, Any]] = []
    for key, child in _children(tree):
        out.extend(tree_flatten_with_path(child, path + (key,)))
    return out


def _tree_map_with_path(fn, tree: Any, path: Tuple = ()) -> Any:
    """The same structure with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(path, tree)
    mapped = [(key, _tree_map_with_path(fn, child, path + (key,)))
              for key, child in _children(tree)]
    if isinstance(tree, dict):
        return {key: value for key, value in mapped}
    values = [value for _key, value in mapped]
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def _key_str(path) -> str:
    return ".".join(str(p) for p in path) if path else "_root"


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: the caller may update it in place later
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))


class CheckpointCorrupt(RuntimeError):
    pass


class CheckpointStore:
    def __init__(self, root: str, keep_last: int = 3) -> None:
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        """Blocking save.  Returns the final checkpoint directory."""
        host_leaves = [
            (_key_str(path), _to_host(leaf))
            for path, leaf in tree_flatten_with_path(tree)
        ]
        return self._write(step, host_leaves, metadata or {})

    def _write(self, step: int,
               host_leaves: List[Tuple[str, np.ndarray]],
               metadata: Dict[str, Any]) -> str:
        tmp = os.path.join(self.root, f"tmp.{step}.{uuid.uuid4().hex[:8]}")
        final = os.path.join(self.root, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {
            "format_version": FORMAT_VERSION,
            "step": step,
            "time": time.time(),
            "metadata": metadata,
            "leaves": {},
        }
        try:
            for name, arr in host_leaves:
                fname = name.replace("/", "_") + ".npy"
                fpath = os.path.join(tmp, fname)
                with open(fpath, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"][name] = {
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "crc32": _crc(arr),
                }
            mpath = os.path.join(tmp, "manifest.json")
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)
        # sweep orphaned tmp dirs from crashed writers
        for d in os.listdir(self.root):
            if d.startswith("tmp."):
                full = os.path.join(self.root, d)
                if time.time() - os.path.getmtime(full) > 3600:
                    shutil.rmtree(full, ignore_errors=True)

    # -- read ---------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.root, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self.root, f"step_{step}", "manifest.json")) as f:
            return json.load(f)

    def restore(
        self,
        step: int,
        like: Any,
        *,
        device: "torch.device | str | None" = None,
        verify: bool = True,
    ) -> Any:
        """Restore into the structure of ``like``.

        ``device``: place every leaf there as a tensor.  Without it, leaves
        come back as host numpy arrays.
        """
        cdir = os.path.join(self.root, f"step_{step}")
        manifest = self.manifest(step)

        def load(path, leaf):
            name = _key_str(path)
            ent = manifest["leaves"].get(name)
            if ent is None:
                raise CheckpointCorrupt(f"leaf {name!r} missing from manifest")
            arr = np.load(os.path.join(cdir, ent["file"]))
            if verify and _crc(arr) != ent["crc32"]:
                raise CheckpointCorrupt(f"crc mismatch for leaf {name!r}")
            if list(arr.shape) != list(np.shape(leaf)):
                raise CheckpointCorrupt(
                    f"shape mismatch for {name!r}: "
                    f"ckpt {arr.shape} vs target {np.shape(leaf)}"
                )
            if device is not None:
                return torch.as_tensor(arr, device=device)
            return arr

        return _tree_map_with_path(load, like)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    return CheckpointStore(root).latest_step()


class AsyncCheckpointer:
    """Background writer: snapshot on submit, write off-thread.

    Guarantees in-order commits (a later step never lands before an earlier
    one) by serializing writes on one worker thread.
    """

    def __init__(self, store: CheckpointStore) -> None:
        self.store = store
        self._err: Optional[BaseException] = None
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def submit(self, step: int, tree: Any,
               metadata: Optional[Dict[str, Any]] = None) -> None:
        self.check()
        # Snapshot to host NOW (the caller may update tensors in place).
        host_leaves = [
            (_key_str(path), _to_host(leaf))
            for path, leaf in tree_flatten_with_path(tree)
        ]
        self.wait()  # serialize: in-order commits

        def work() -> None:
            try:
                self.store._write(step, host_leaves, metadata or {})
            except BaseException as e:  # surfaced on next submit/wait
                with self._lock:
                    self._err = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._pending = t

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self.check()

    def check(self) -> None:
        with self._lock:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
