"""Persistent step cache: prepared Lloyd steps that outlive batches.

The kernel and plain paradigms run the same masked Lloyd step for every
batch of a given (bucket shape, k/dim, params) class.  This module makes
that step an explicit, service-lifetime object:

- keyed by ``(algo, step kind, padded shape, feature dim, params)`` so
  every batch with the same bucket shape reuses one prepared step;
- nothing is compiled per shape: the CUDA kernels are built once per
  process from ``csrc/`` and take any shape.  A prepared entry is the step
  bound to its config and device.  :meth:`ExecutableCache.warm_kmeans`
  builds the kernels and launches the step once on zeros of the bucket
  shape, so the first request pays neither the ``nvcc`` build nor the
  first launch;
- counted: ``hits`` / ``misses`` / ``warmed`` feed the service metrics
  snapshot, so a run can show zero misses after warm-up.

A failed build or launch raises: the cache never hands back the plain step
in place of the kernel step.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch


class ExecutableCache:
    """Thread-safe (key -> prepared step) registry with pre-warming."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self.warmed = 0

    # -- keys ----------------------------------------------------------------

    @staticmethod
    def _kmeans_key(n_pad: int, d: int, cfg, device) -> Tuple:
        kind = "fused" if cfg.use_kernel else "ref"
        # every cfg field that changes the step, and where it runs
        return ("kmeans", kind, int(n_pad), int(d),
                (int(cfg.k), str(cfg.init)), str(torch.device(device)))

    # -- lookup --------------------------------------------------------------

    def kmeans_step(self, n_pad: int, d: int, cfg,
                    device: "torch.device | str" = "cuda") -> Callable:
        """Masked Lloyd step for (n_pad, d) items under ``cfg`` on
        ``device``.

        The returned callable takes ``(x (n_pad, d) f32, c (k, d) f32,
        mask (n_pad,) bool)`` on ``device`` and returns ``(assign, c_new,
        shift, inertia)`` — cfg is baked in.
        """
        key = self._kmeans_key(n_pad, d, cfg, device)
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self.hits += 1
                return fn
        fn = self._prepare_kmeans(cfg, device)
        with self._lock:
            # racing preparers: first writer wins, the rest reuse it
            fn = self._entries.setdefault(key, fn)
            self.misses += 1
        return fn

    def warm_kmeans(self, n_pad: int, d: int, cfg,
                    device: "torch.device | str" = "cuda") -> bool:
        """Prepare one step and run it once on zeros of the bucket shape;
        True if newly built.  Raises if the kernel fails to build or
        launch."""
        key = self._kmeans_key(n_pad, d, cfg, device)
        with self._lock:
            if key in self._entries:
                return False
        fn = self._prepare_kmeans(cfg, device)
        x = torch.zeros((int(n_pad), int(d)), dtype=torch.float32,
                        device=device)
        c = torch.zeros((int(cfg.k), int(d)), dtype=torch.float32,
                        device=device)
        mask = torch.zeros((int(n_pad),), dtype=torch.bool, device=device)
        fn(x, c, mask)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        with self._lock:
            if key in self._entries:
                return False
            self._entries[key] = fn
            self.warmed += 1
        return True

    # -- preparation ---------------------------------------------------------

    def _prepare_kmeans(self, cfg, device) -> Callable:
        from repro_torch.core import kmeans

        if cfg.use_kernel and torch.device(device).type == "cuda":
            from repro_torch.kernels.distance import fused

            fused.build()   # nvcc at first use; raises if the build fails
        return functools.partial(kmeans.masked_step_fn(cfg), cfg=cfg)

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "warmed": self.warmed,
            }


_default: Optional[ExecutableCache] = None
_default_lock = threading.Lock()


def default_exec_cache() -> ExecutableCache:
    """Process-wide cache shared by every paradigm instance (the built
    kernels are process-global anyway — one registry to count them)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ExecutableCache()
        return _default
