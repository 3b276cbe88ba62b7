"""K-Means (Lloyd) — the paper's algorithm on one device.

Paper semantics kept exactly (§II.C):
- Lloyd iterations, single precision;
- stop when the sum of absolute centroid displacements < 1e-6, or after
  100,000 iterations ("should avoid endless loops due to cycling which
  occurs from time to time with single precision");
- the assignment step is the accelerator kernel (one kernel: distance to
  every center + argmin) — here ``csrc/distance.cu`` through
  :mod:`repro_torch.kernels.distance`;
- the per-point cluster id is stored in a 16-bit word (int16 labels);
- an empty cluster keeps its old center (the paper does not respawn).

The centroid update is one-hot(assign)^T . X, a (k, n) x (n, d) matrix
product left to ``torch.matmul`` — not a scatter with float atomics, which
would make the sums change from run to run.

Loops run on the host: :func:`fit` to the stop rule, and
:func:`fit_cancellable` polling a
:class:`~repro_torch.core.cancellation.CancellationToken` between steps
("the flag is tested between OpenCL kernel executions").  Randomness comes
from a ``torch.Generator`` (or an int seed), deterministic within this
package; it cannot reproduce the reference's ``jax.random`` draws, so
cross-package checks pass explicit centroids.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.cancellation import CancellationToken
from repro_torch.kernels.distance.fused import fused_masked_assign_update
from repro_torch.kernels.distance.ops import assign_clusters
from repro_torch.kernels.distance.ref import assign_clusters_ref

# Paper defaults.
PAPER_TOL = 1e-6
PAPER_MAX_ITERS = 100_000

Seed = Union[int, torch.Generator]


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    k: int
    max_iters: int = PAPER_MAX_ITERS
    tol: float = PAPER_TOL
    init: str = "sample"          # "sample" (paper: random points) | "kmeans++"
    use_kernel: bool = True        # CUDA assignment kernel vs plain torch


@dataclasses.dataclass
class KMeansResult:
    centroids: torch.Tensor   # (k, d) f32
    labels: torch.Tensor      # (n,) int16 — paper's 16-bit per-point word
    inertia: torch.Tensor     # () f32 sum of squared distances
    iterations: torch.Tensor  # () i32
    converged: torch.Tensor   # () bool (False if cancelled / max_iters)
    cancelled: bool = False


def _generator(seed: Seed) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def _assign(x, c, cfg: KMeansConfig):
    if cfg.use_kernel:
        return assign_clusters(x, c)
    return assign_clusters_ref(x, c)


def _weighted_sums(x, assign, k: int, w=None):
    """Per-centroid (sums (k, d), counts (k,)) via the one-hot product.

    The one-hot matrix is built by comparison (a bool (n, k), then fp32)
    rather than ``F.one_hot``, whose int64 (n, k) intermediate is twice the
    size of the fp32 matrix it feeds.
    """
    cols = torch.arange(k, dtype=assign.dtype, device=assign.device)
    onehot = (assign[:, None] == cols[None, :]).to(torch.float32)
    if w is not None:
        onehot = onehot * w[:, None]
    return onehot.T @ x.float(), onehot.sum(0)


def _new_centroids(sums, counts, c_old):
    has_pts = counts > 0
    safe = torch.where(has_pts, counts, torch.ones_like(counts))[:, None]
    # empty cluster: keep the old center (paper does not respawn centers)
    return torch.where(has_pts[:, None], sums / safe, c_old)


def _update_centroids(x, assign, k: int, c_old):
    """One-hot matmul centroid update."""
    sums, counts = _weighted_sums(x, assign, k)
    return _new_centroids(sums, counts, c_old)


def kmeans_step(x, c, cfg: KMeansConfig):
    """(assignment, new centroids, displacement, inertia)."""
    assign, d2 = _assign(x, c, cfg)
    c_new = _update_centroids(x, assign, cfg.k, c)
    shift = torch.sum(torch.abs(c_new - c))
    return assign, c_new, shift, torch.sum(d2)


def masked_kmeans_step(x, c, mask, cfg: KMeansConfig):
    """Lloyd step over a padded batch item: masked-out rows carry no weight.

    With ``mask`` all-True this is :func:`kmeans_step` on the same rows;
    padded rows are still assigned but contribute zero to the centroid
    sums, counts, and inertia.
    """
    assign, d2 = _assign(x, c, cfg)
    w = mask.to(torch.float32)
    sums, counts = _weighted_sums(x, assign, cfg.k, w)
    c_new = _new_centroids(sums, counts, c)
    shift = torch.sum(torch.abs(c_new - c))
    return assign, c_new, shift, torch.sum(d2 * w)


def fused_masked_kmeans_step(x, c, mask, cfg: KMeansConfig):
    """:func:`masked_kmeans_step` via the fused kernel (``csrc/fused.cu``).

    Distance, argmin, and the masked per-centroid sum/count/inertia
    accumulation happen in one kernel call over ``x``; only the
    empty-cluster fix-up and the shift reduction remain plain tensor ops.
    Same (assign, c_new, shift, inertia) contract as the two-pass step.
    """
    assign, sums, counts, inertia = fused_masked_assign_update(x, c, mask)
    c_new = _new_centroids(sums, counts, c)
    shift = torch.sum(torch.abs(c_new - c))
    return assign, c_new, shift, inertia


def masked_step_fn(cfg: KMeansConfig):
    """The serving hot loop's step: the fused kernel for kernel configs,
    the plain two-pass step otherwise (the ``torch-ref`` paradigm)."""
    if cfg.use_kernel:
        return fused_masked_kmeans_step
    return masked_kmeans_step


def init_centroids(seed: Seed, x: torch.Tensor,
                   cfg: KMeansConfig) -> torch.Tensor:
    gen = _generator(seed)
    if cfg.init == "sample":
        # paper: "initial cluster centers were selected randomly by each
        # implementation"
        idx = torch.randperm(x.shape[0], generator=gen)[:cfg.k]
        return x[idx.to(x.device)].float()
    if cfg.init == "kmeans++":
        return _kmeans_pp(gen, x, cfg.k)
    raise ValueError(f"unknown init {cfg.init!r}")


def _kmeans_pp(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding (beyond-paper; D^2 sampling).

    The uniform draws come from ``gen`` on the host; the D^2 distribution
    is inverted on x's device, so the seeding does not depend on where the
    generator lives.
    """
    n, d = x.shape
    xf = x.float()
    first = int(torch.randint(0, n, (), generator=gen))
    cents = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    cents[0] = xf[first]
    mind2 = torch.sum((xf - xf[first]) ** 2, dim=1)
    for i in range(1, k):
        u = float(torch.rand((), generator=gen, dtype=torch.float64))
        cdf = torch.cumsum(mind2.double(), 0)
        target = torch.tensor([u * float(cdf[-1])], dtype=torch.float64,
                              device=x.device)
        nxt = int(torch.searchsorted(cdf, target, right=True).clamp(max=n - 1))
        cents[i] = xf[nxt]
        mind2 = torch.minimum(mind2, torch.sum((xf - xf[nxt]) ** 2, dim=1))
    return cents


def fit(seed: Seed, x: torch.Tensor, cfg: KMeansConfig) -> KMeansResult:
    """Lloyd loop to the paper's stop rule (host loop, no cancellation).

    Like the reference's ``while shift >= tol`` loop it stops at the first
    shift that is not ``>= tol``, so a NaN shift (NaN input) ends it after
    that step; :func:`fit_cancellable`, like the reference's, runs a NaN
    shift on to ``max_iters``.
    """
    c = init_centroids(seed, x, cfg)
    assign = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    inertia = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    shift_f, it = float("inf"), 0
    while shift_f >= cfg.tol and it < cfg.max_iters:
        assign, c, shift, inertia = kmeans_step(x, c, cfg)
        shift_f = float(shift)
        it += 1
    return KMeansResult(
        centroids=c,
        labels=assign.to(torch.int16),
        inertia=inertia,
        iterations=torch.tensor(it, dtype=torch.int32),
        converged=torch.tensor(shift_f < cfg.tol),
        cancelled=False,
    )


def fit_cancellable(
    seed: Seed,
    x: torch.Tensor,
    cfg: KMeansConfig,
    token: Optional[CancellationToken] = None,
    on_progress: Optional[Callable[[int, float], None]] = None,
    *,
    centroids: Optional[torch.Tensor] = None,
    start_iteration: int = 0,
) -> KMeansResult:
    """Host-driven Lloyd loop; abort flag polled between steps.

    ``centroids``/``start_iteration`` resume an interrupted run: the full
    run state of Lloyd's algorithm is the centroid matrix plus the iteration
    counter, both of which live in the returned result — checkpoint those,
    pass them back in, and the loop continues exactly where it stopped.
    """
    c = (torch.as_tensor(centroids, dtype=torch.float32, device=x.device)
         if centroids is not None else init_centroids(seed, x, cfg))
    assign = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    inertia = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    it = start_iteration
    converged = False
    cancelled = False
    for it in range(start_iteration + 1, cfg.max_iters + 1):
        if token is not None and token.cancelled():
            cancelled = True
            it -= 1
            break
        assign, c, shift, inertia = kmeans_step(x, c, cfg)
        shift_f = float(shift)
        if on_progress is not None:
            on_progress(it, shift_f)
        if shift_f < cfg.tol:
            converged = True
            break
    return KMeansResult(
        centroids=c,
        labels=assign.to(torch.int16),
        inertia=inertia,
        iterations=torch.tensor(it, dtype=torch.int32),
        converged=torch.tensor(converged),
        cancelled=cancelled,
    )


@dataclasses.dataclass
class MiniBatchState:
    """Running mini-batch K-Means model: the whole state of a stream.

    ``centroids`` and per-cluster ``counts`` are the Sculley (2010)
    accumulator; ``step`` counts applied mini-batches.  The tree form
    (:meth:`as_tree` / :meth:`from_tree`) is host numpy, the same layout
    the reference package checkpoints.
    """

    centroids: torch.Tensor   # (k, d) f32
    counts: torch.Tensor      # (k,) f32 — per-cluster points seen so far
    step: int = 0             # mini-batches applied
    n_seen: int = 0           # raw points consumed

    def as_tree(self) -> dict:
        return {
            "centroids": self.centroids.detach().cpu().numpy().astype(np.float32),
            "counts": self.counts.detach().cpu().numpy().astype(np.float32),
            "step": np.int64(self.step),
            "n_seen": np.int64(self.n_seen),
        }

    @staticmethod
    def from_tree(tree: dict, device: torch.device | str = "cpu"
                  ) -> "MiniBatchState":
        return MiniBatchState(
            centroids=torch.as_tensor(np.asarray(tree["centroids"], np.float32),
                                      device=device),
            counts=torch.as_tensor(np.asarray(tree["counts"], np.float32),
                                   device=device),
            step=int(tree["step"]),
            n_seen=int(tree["n_seen"]),
        )


def minibatch_init(seed: Seed, x0: torch.Tensor,
                   cfg: KMeansConfig) -> MiniBatchState:
    """Seed a stream's model from its first ``>= k`` points."""
    if x0.shape[0] < cfg.k:
        raise ValueError(
            f"need at least k={cfg.k} points to initialise, got {x0.shape[0]}")
    return MiniBatchState(
        centroids=init_centroids(seed, x0, cfg),
        counts=torch.zeros((cfg.k,), dtype=torch.float32, device=x0.device),
    )


def _minibatch_update(c, counts, xb, cfg: KMeansConfig):
    """One Sculley step: per-cluster learning rate 1/count."""
    assign, d2 = _assign(xb, c, cfg)
    bsums, bcounts = _weighted_sums(xb, assign, cfg.k)
    counts_new = counts + bcounts
    lr = torch.where(bcounts > 0, bcounts / torch.clamp_min(counts_new, 1.0),
                     torch.zeros_like(bcounts))
    bmean = bsums / torch.clamp_min(bcounts, 1.0)[:, None]
    c_new = c + lr[:, None] * (bmean - c)
    return c_new, counts_new, assign, torch.sum(d2)


def minibatch_step(state: MiniBatchState, xb: torch.Tensor,
                   cfg: KMeansConfig) -> MiniBatchState:
    """Advance a stream's model by one mini-batch."""
    xb = torch.as_tensor(xb, dtype=torch.float32, device=state.centroids.device)
    c, counts, _, _ = _minibatch_update(state.centroids, state.counts, xb, cfg)
    return MiniBatchState(
        centroids=c,
        counts=counts,
        step=state.step + 1,
        n_seen=state.n_seen + int(xb.shape[0]),
    )


def minibatch_fit(
    seed: Seed,
    x: torch.Tensor,
    cfg: KMeansConfig,
    *,
    batch_size: int = 1024,
    steps: int = 200,
) -> KMeansResult:
    """Mini-batch K-Means (Sculley 2010) — beyond-paper extra for streams."""
    gen = _generator(seed)
    c = init_centroids(gen, x, cfg)
    counts = torch.zeros((cfg.k,), dtype=torch.float32, device=x.device)
    n = x.shape[0]
    for _ in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=gen)
        c, counts, _, _ = _minibatch_update(c, counts, x[idx.to(x.device)], cfg)
    assign, d2 = _assign(x, c, cfg)
    return KMeansResult(
        centroids=c,
        labels=assign.to(torch.int16),
        inertia=torch.sum(d2),
        iterations=torch.tensor(steps, dtype=torch.int32),
        converged=torch.tensor(True),
    )
