"""StreamingSession — unbounded point streams over mini-batch K-Means.

The batch API answers "cluster this dataset"; a stream never has a whole
dataset.  A session folds arriving points through
:func:`repro_torch.core.kmeans.minibatch_step` (Sculley 2010) and keeps the
entire model — centroids, per-cluster counts, step counter — as a
:class:`~repro_torch.core.kmeans.MiniBatchState` persisted through the same
atomic :class:`~repro_torch.checkpoint.store.CheckpointStore` the batch executor
uses.  That makes streams preemption-safe the way the paper's WorkManager
jobs are: SIGTERM (or kill -9) between checkpoints loses at most the last
``checkpoint_every`` mini-batches plus the unprocessed buffer; re-opening
the same ``(tenant, name)`` resumes the model from its last verified
checkpoint.

One session is single-writer (guarded by a lock for safety, but the
intended topology is one producer per stream); distinct tenants and
distinct stream names never share state — each maps to its own checkpoint
directory under ``<root>/<tenant>__<name>``.

The model lives on ``device`` (``"cuda"`` unless the caller asks for the
CPU); its checkpoints are host numpy in the reference's layout.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import kmeans
from repro_torch.kernels.distance.ops import assign_clusters
from repro_torch.runtime import backend as backend_mod

_SAFE = re.compile(r"[^A-Za-z0-9.-]")


def _slug(s: str) -> str:
    """Filesystem-safe AND collision-free name component.

    Sanitising alone is lossy ('a/b' and 'a-b' would share a directory,
    and '__' inside a tenant name would fake the tenant/stream separator),
    so a short content hash of the raw string rides along — distinct
    tenants or stream names can never share checkpoint state.
    """
    digest = hashlib.sha256(s.encode()).hexdigest()[:8]
    return f"{_SAFE.sub('-', s)}-{digest}"


class StreamingSession:
    """Per-tenant streaming K-Means with checkpointed model state.

    ``push()`` buffers points and applies one mini-batch update per
    ``batch_size`` buffered; the model checkpoints every
    ``checkpoint_every`` applied steps and on ``close()``.  The first
    ``>= k`` points seed the centroids (the paper's random-sample init).
    """

    def __init__(
        self,
        root: str,
        tenant: str,
        name: str = "default",
        *,
        k: int,
        batch_size: int = 256,
        checkpoint_every: int = 8,
        seed: int = 0,
        keep_last: int = 3,
        device: str = "cuda",
        **cfg_kwargs: Any,
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = backend_mod.load(device).device
        self.tenant = tenant
        self.name = name
        # streaming batches are small; the plain assignment is the right
        # default for the update step (use_kernel=True opts into the kernel)
        cfg_kwargs.setdefault("use_kernel", False)
        self.cfg = kmeans.KMeansConfig(k=k, **cfg_kwargs)
        self.batch_size = batch_size
        self.checkpoint_every = max(1, checkpoint_every)
        self.seed = seed
        self.store = CheckpointStore(
            os.path.join(root, f"{_slug(tenant)}__{_slug(name)}"),
            keep_last=keep_last)
        self._lock = threading.Lock()
        self._buffer: list = []      # pending np arrays, FIFO
        self._buffered = 0
        self._closed = False
        self.state: Optional[kmeans.MiniBatchState] = self._restore()

    # -- persistence ---------------------------------------------------------

    def _restore(self) -> Optional[kmeans.MiniBatchState]:
        step = self.store.latest_step()
        if step is None:
            return None
        manifest = self.store.manifest(step)
        ckpt_k = int(manifest["leaves"]["centroids"]["shape"][0])
        if ckpt_k != self.cfg.k:
            raise ValueError(
                f"stream {self.tenant}/{self.name} was checkpointed with "
                f"k={ckpt_k}, cannot reopen with k={self.cfg.k}")
        like = {
            leaf: np.zeros(ent["shape"], dtype=np.dtype(ent["dtype"]))
            for leaf, ent in manifest["leaves"].items()
        }
        tree = self.store.restore(step, like)
        return kmeans.MiniBatchState.from_tree(
            {key: np.asarray(val) for key, val in tree.items()},
            device=self.device)

    def checkpoint(self) -> Optional[str]:
        """Persist the model now; returns the checkpoint path (None before
        the model is initialised)."""
        with self._lock:
            return self._checkpoint_locked()

    def _checkpoint_locked(self) -> Optional[str]:
        if self.state is None:
            return None
        return self.store.save(
            self.state.step, self.state.as_tree(),
            metadata={"tenant": self.tenant, "stream": self.name,
                      "k": self.cfg.k})

    # -- the stream ----------------------------------------------------------

    def push(self, points: np.ndarray) -> int:
        """Feed points into the stream; returns mini-batch steps applied.

        Points buffer until a full ``batch_size`` is available, then fold
        into the model one batch at a time.
        """
        if self._closed:
            raise RuntimeError(f"stream {self.tenant}/{self.name} is closed")
        points = np.ascontiguousarray(np.asarray(points, np.float32))
        if points.ndim != 2 or points.shape[0] < 1:
            raise ValueError(f"points must be (n, d), got {points.shape}")
        with self._lock:
            if self.state is not None:
                d = int(self.state.centroids.shape[1])
                if points.shape[1] != d:
                    raise ValueError(
                        f"stream {self.tenant}/{self.name} has d={d}, "
                        f"got points with d={points.shape[1]}")
            self._buffer.append(points)
            self._buffered += points.shape[0]
            return self._process_locked(final=False)

    def flush(self) -> int:
        """Fold any buffered remainder through as one (short) mini-batch."""
        with self._lock:
            return self._process_locked(final=True)

    def _take_locked(self, count: int) -> np.ndarray:
        out, need = [], count
        while need > 0:
            head = self._buffer[0]
            if head.shape[0] <= need:
                out.append(self._buffer.pop(0))
                need -= head.shape[0]
            else:
                out.append(head[:need])
                self._buffer[0] = head[need:]
                need = 0
        self._buffered -= count
        return out[0] if len(out) == 1 else np.concatenate(out)

    def _take_device_locked(self, count: int) -> torch.Tensor:
        return torch.as_tensor(self._take_locked(count), device=self.device)

    def _process_locked(self, final: bool) -> int:
        applied = 0
        # seed the model once >= k points have arrived
        if self.state is None:
            if self._buffered < self.cfg.k:
                return 0
            # the seeding take must cover k even when batch_size < k —
            # minibatch_init needs k distinct sample points
            x0 = self._take_device_locked(
                min(self._buffered, max(self.batch_size, self.cfg.k)))
            self.state = kmeans.minibatch_init(self.seed, x0, self.cfg)
            # the seeding points also train: they are part of the stream
            self.state = kmeans.minibatch_step(self.state, x0, self.cfg)
            applied += 1
        while self._buffered >= self.batch_size:
            xb = self._take_device_locked(self.batch_size)
            self.state = kmeans.minibatch_step(self.state, xb, self.cfg)
            applied += 1
        if final and self._buffered > 0:
            xb = self._take_device_locked(self._buffered)
            self.state = kmeans.minibatch_step(self.state, xb, self.cfg)
            applied += 1
        if applied:
            before = self.state.step - applied
            if self.state.step // self.checkpoint_every > \
                    before // self.checkpoint_every:
                self._checkpoint_locked()
        return applied

    # -- reads ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Current model view (centroids are None before initialisation)."""
        with self._lock:
            if self.state is None:
                return {"initialized": False, "tenant": self.tenant,
                        "stream": self.name, "buffered": self._buffered,
                        "centroids": None, "step": 0, "n_seen": 0}
            return {
                "initialized": True,
                "tenant": self.tenant,
                "stream": self.name,
                "buffered": self._buffered,
                "centroids": self.state.centroids.cpu().numpy().astype(
                    np.float32),
                "counts": self.state.counts.cpu().numpy().astype(np.float32),
                "step": self.state.step,
                "n_seen": self.state.n_seen,
            }

    def assign(self, points: np.ndarray) -> np.ndarray:
        """Classify points against the current centroids (int16 labels,
        the paper's per-point word); does not advance the stream."""
        with self._lock:
            if self.state is None:
                raise RuntimeError(
                    f"stream {self.tenant}/{self.name} has no model yet "
                    f"(needs >= k={self.cfg.k} points)")
            centroids = self.state.centroids
        # the assignment kernel on a CUDA device, its plain version on CPU
        x = torch.as_tensor(np.ascontiguousarray(points, np.float32),
                            device=self.device)
        labels, _ = assign_clusters(x, centroids, with_dists=False)
        return labels.cpu().numpy().astype(np.int16)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Flush the buffer and write a final checkpoint."""
        if self._closed:
            return
        with self._lock:
            self._process_locked(final=True)
            self._checkpoint_locked()
            self._closed = True

    def __enter__(self) -> "StreamingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
