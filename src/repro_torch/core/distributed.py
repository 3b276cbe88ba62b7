"""Distributed clustering — one request sharded over a mesh of devices.

One process drives every shard (single controller, as the reference's
mesh of local devices): a :class:`Mesh` is a tuple of ``torch.device``
and an axis name, and shard ``i`` of the rows lives on ``devices[i]``.
A mesh may name one device several times (``Mesh((cpu,) * 4)``, or four
shards on the one H100): p shards then run on one device, which is how the
tests and ``chip_smoke.py`` exercise p > 1 without p cards.

Two strategies, as in the reference:

1. **Row-sharded Lloyd step** (:func:`make_sharded_masked_kmeans_step`):
   the item's rows are cut at whole blocks of the fused step's launch over
   all of them (:func:`kmeans_bounds`); each shard runs the fused kernel's
   pass 1 on its rows against the replicated centroids
   (``fused.fused_masked_partials``: ``csrc/fused.cu`` on a card, its
   plain version on the CPU), which writes the one launch's partial sums,
   block for block; pass 2 (``fused.reduce_partials``) adds every shard's
   partials on ``devices[0]`` in block order, and the centroids are formed
   as the single-device step forms them.  So the step is the
   ``cuda-kernel`` lane's, bit for bit, at every shard count (no atomics:
   it does not change from run to run either).

2. **Ring** (:func:`ring_degree`, :func:`ring_expand`): each device keeps
   its row shard; the column shards rotate p times
   (``Tensor.to(next_device)``, nothing where the device repeats), and at
   each step a shard's rows meet the column shard it holds through the
   cross neighbour entries (``csrc/neighbor.cu`` item 7): p^2 launches a
   ring call.  The (n, n) adjacency exists nowhere, and no (n/p, n/p)
   tile either: the kernel decides each pair from a tensor-core candidate
   and an exact recheck.  Degrees are integer counts from an exact
   decision, so they equal ``epsilon_degree_ref`` for every p.

Both back the serving layer's ``distributed`` paradigm
(:mod:`repro_torch.service.dispatch`) through the resumable host loops at
the bottom: :func:`sharded_kmeans_fit_resumable` and
:func:`sharded_dbscan_fit_resumable` poll the abort flag between launches
and report state gathered to the host (centroids and iteration; the packed
int16 word and frontier), which does not depend on the mesh's shape: a
checkpoint written at p = 4 resumes at p = 1 (or 3, or 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dbscan, kmeans
from repro_torch.core.cancellation import CancellationToken
from repro_torch.kernels.distance import fused
from repro_torch.kernels.neighbor.ops import (
    epsilon_degree_cross,
    expand_frontier_cross,
)
from repro_torch.kernels.neighbor.ref import (
    epsilon_degree_cross_ref,
    expand_frontier_cross_ref,
)

Shards = List[torch.Tensor]
ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard ``i`` of the rows on ``devices[i]``."""

    devices: Tuple[torch.device, ...]
    axis: str = "data"

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def local_mesh(axis: str = "data", device: str = "cuda") -> Mesh:
    """1-D mesh over every local device of ``device``'s kind (the serving
    layer's shard domain): each CUDA card, or the host for ``"cpu"``.

    Device discovery goes through :func:`repro_torch.runtime.backend.
    discover_backend`, never at import time.
    """
    from repro_torch.runtime import backend as backend_mod

    return Mesh(tuple(backend_mod.discover_backend(device).devices), axis)


def shard_rows(n: int, shards: int) -> int:
    """Rows per shard so ``shards * shard_rows(n, shards) >= n``."""
    return -(-n // max(1, shards))


def _cut(mesh: Mesh, t, bounds) -> Shards:
    t = torch.as_tensor(t)
    return [t[a:b].to(dev).contiguous()
            for (a, b), dev in zip(bounds, mesh.devices)]


def shard(mesh: Mesh, x: ArrayLike) -> Shards:
    """Rows of x cut into ``mesh.size`` blocks of ``shard_rows`` rows (the
    last ones shorter, or empty, when n is not a multiple), block ``i``
    moved to ``devices[i]``."""
    n = torch.as_tensor(x).shape[0]
    r = shard_rows(n, mesh.size)
    return _cut(mesh, x, [(min(n, i * r), min(n, (i + 1) * r))
                          for i in range(mesh.size)])


def gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' rows in order, on ``devices[0]``."""
    dev = mesh.devices[0]
    if len(parts) == 1 and parts[0].device == dev:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts])


def _as_shards(mesh: Mesh, x) -> Shards:
    return list(x) if isinstance(x, (list, tuple)) else shard(mesh, x)


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")


# ---------------------------------------------------------------------------
# Strategy 1: row-sharded Lloyd step
# ---------------------------------------------------------------------------


def kmeans_bounds(n: int, k: int, d: int,
                  shards: int) -> List[Tuple[int, int]]:
    """Row ranges of the shards of a K-Means item of n rows: runs of whole
    pass-1 blocks of the fused step's launch over all n rows
    (``fused.block_rows``), shard i the blocks [i B / p, (i + 1) B / p)
    (empty where there are fewer blocks than shards).  Cut there, the
    shards' partials are the one launch's, block for block."""
    if n == 0:
        return [(0, 0)] * shards
    rows = fused.block_rows(n, k, d)
    blocks = -(-n // rows)
    cut = [min(n, rows * (i * blocks // shards)) for i in range(shards + 1)]
    return list(zip(cut[:-1], cut[1:]))


def _side_by_side(calls: Sequence[Callable[[], Tuple[torch.Tensor, ...]]],
                  devices: Sequence[torch.device]) -> list:
    """``calls[i]()`` for each shard, its kernels queued for
    ``devices[i]``.  Where the mesh names one CUDA device more than once,
    each of its shards runs on a side stream of its own, so the shards'
    launches run side by side on the card as they would on distinct
    cards; the device's current stream waits for them all before this
    returns.  The results are the same bits in any order."""
    repeated = {dev for dev in devices
                if dev.type == "cuda" and list(devices).count(dev) > 1}
    out, sides = [], []
    for call, dev in zip(calls, devices):
        if dev not in repeated:
            out.append(call())
            continue
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            res = call()
        for t in res:
            t.record_stream(main)   # freed only after main's use
        out.append(res)
        sides.append((main, side))
    for main, side in sides:
        main.wait_stream(side)
    return out


def make_sharded_masked_kmeans_step(mesh: Mesh, cfg: kmeans.KMeansConfig):
    """``step(xs, c, ms) -> (assign, c_new, shift, inertia)`` over a padded
    item: ``xs`` and the validity mask ``ms`` row-sharded (lists of shards
    cut by :func:`kmeans_bounds`, or whole tensors, cut per call), ``c``
    replicated.  Masked-out rows carry no weight.  ``assign`` is gathered
    on ``devices[0]``, as are the centroids, the shift and the inertia.

    Kernel configs run the fused step's two passes (bit for bit the one
    launch's step; on a mesh that repeats a card, the shards' pass-1
    launches on side streams, side by side); plain configs add the
    two-pass step's partial sums in shard order, one shard after
    another."""
    dev0 = mesh.devices[0]

    def step(xs, c, ms):
        if not isinstance(xs, (list, tuple)):
            bounds = kmeans_bounds(xs.shape[0], cfg.k, xs.shape[1],
                                   mesh.size)
            xs, ms = _cut(mesh, xs, bounds), _cut(mesh, ms, bounds)
        d = xs[0].shape[1]
        if cfg.use_kernel:
            rows = fused.block_rows(sum(x.shape[0] for x in xs), cfg.k, d)
            start = 0
            for x in xs:
                if x.shape[0] and start % rows:
                    raise ValueError(f"a shard starts at row {start}, not "
                                     f"at a block of {rows} rows")
                start += x.shape[0]
            parts = _side_by_side(
                [lambda x=x, m=m: fused.fused_masked_partials(
                    x, c.to(x.device), m, rows) for x, m in zip(xs, ms)],
                [x.device for x in xs])
            assign = gather(mesh, [a for a, _ in parts])
            sums, counts, inertia = fused.reduce_partials(
                torch.cat([p.to(dev0) for _, p in parts]), cfg.k, d)
        else:
            parts = [kmeans.masked_partials(x, c.to(x.device), m, cfg)
                     for x, m in zip(xs, ms)]
            assign = gather(mesh, [p[0] for p in parts])
            _, sums, counts, inertia = (t.to(dev0) for t in parts[0])
            for _, s, k, e in parts[1:]:
                sums = sums + s.to(dev0)
                counts = counts + k.to(dev0)
                inertia = inertia + e.to(dev0)
        c_new, shift = kmeans.update_from_partials(c, sums, counts)
        return assign, c_new, shift, inertia

    return step


def make_sharded_kmeans_step(mesh: Mesh, cfg: kmeans.KMeansConfig):
    """``step(x, c)``: :func:`make_sharded_masked_kmeans_step` with every
    row valid."""
    masked = make_sharded_masked_kmeans_step(mesh, cfg)

    def step(x, c):
        x = torch.as_tensor(x)
        return masked(x, c, torch.ones(x.shape[0], dtype=torch.bool,
                                       device=x.device))

    return step


# ---------------------------------------------------------------------------
# Strategy 2: ring
# ---------------------------------------------------------------------------


def _move(held, dev: torch.device):
    if isinstance(held, tuple):
        return tuple(t.to(dev) for t in held)
    return held.to(dev)


def _ring_body(mesh: Mesh, rows: Shards, cols0: list, combine) -> list:
    """Rotate the column shards around the ring, p steps; at each, fold
    shard i's rows against the column shard it holds into acc[i]
    (``combine(acc, rows, cols, shard_idx)``, acc None at first)."""
    p = mesh.size
    acc: list = [None] * p
    held = list(cols0)          # held[i]: the column shard device i holds
    for step in range(p):
        for i in range(p):
            acc[i] = combine(acc[i], rows[i], held[i], (i - step) % p)
        if step + 1 < p:
            held = [_move(held[(i - 1) % p], mesh.devices[i])
                    for i in range(p)]
    return acc


def make_ring_degree(mesh: Mesh, eps: float, axis: str = "data",
                     use_kernel: bool = True):
    """``degree(xs) -> per-shard int32 degrees``: each shard's rows against
    every column shard through the cross entry, p^2 launches."""
    _check_axis(mesh, axis)
    fn = epsilon_degree_cross if use_kernel else epsilon_degree_cross_ref
    eps = float(eps)

    def combine(acc, rows, cols, _):
        deg = fn(rows, cols, eps)
        return deg if acc is None else acc + deg

    def degree(xs) -> Shards:
        xs = _as_shards(mesh, xs)
        return _ring_body(mesh, xs, xs, combine)

    return degree


def make_ring_expand(mesh: Mesh, eps: float, axis: str = "data",
                     use_kernel: bool = True):
    """``expand(xs, fs) -> per-shard bool reach`` (one BFS depth): the
    frontier shards rotate with their column shards, p^2 launches."""
    _check_axis(mesh, axis)
    fn = expand_frontier_cross if use_kernel else expand_frontier_cross_ref
    eps = float(eps)

    def combine(acc, rows, cols_and_f, _):
        cols, f = cols_and_f
        hit = fn(rows, cols, f, eps)
        return hit if acc is None else acc | hit

    def expand(xs, fs) -> Shards:
        xs, fs = _as_shards(mesh, xs), _as_shards(mesh, fs)
        return _ring_body(mesh, xs, list(zip(xs, fs)), combine)

    return expand


def ring_degree(mesh: Mesh, x, eps: float,
                axis: str = "data") -> torch.Tensor:
    """deg[i] over row-sharded x (a tensor, or its shards), on
    ``devices[0]``: ``epsilon_degree_ref(x)``'s bits for every p."""
    return gather(mesh, make_ring_degree(mesh, eps, axis)(x))


def ring_expand(mesh: Mesh, x, frontier, eps: float,
                axis: str = "data") -> torch.Tensor:
    """reach[i] = any_j adj[i, j] & frontier[j], ring-rotated like
    :func:`ring_degree`: ``expand_frontier_ref(x, frontier)``'s bits."""
    return gather(mesh, make_ring_expand(mesh, eps, axis)(x, frontier))


# ---------------------------------------------------------------------------
# Resumable sharded fits — the serving layer's oversized-request path
# ---------------------------------------------------------------------------


def sharded_kmeans_fit_resumable(
    mesh: Mesh,
    x_pad: ArrayLike,
    mask: ArrayLike,
    cfg: kmeans.KMeansConfig,
    token: Optional[CancellationToken] = None,
    *,
    centroids: ArrayLike,
    start_iteration: int = 0,
    on_state: Optional[Callable[[Dict[str, np.ndarray]], None]] = None,
    state_interval: int = 8,
) -> Tuple[kmeans.KMeansResult, Optional[Dict[str, np.ndarray]]]:
    """Masked Lloyd host loop with points and mask row-sharded over the
    mesh (:func:`kmeans_bounds`).

    Returns ``(result, mid_state)`` where ``mid_state`` is the resume
    snapshot on cancellation (None otherwise), in the tree form the
    single-device paradigm checkpoints.  The result's tensors are on
    ``devices[0]``.
    """
    step = make_sharded_masked_kmeans_step(mesh, cfg)
    x = torch.as_tensor(x_pad).float()
    bounds = kmeans_bounds(x.shape[0], cfg.k, x.shape[1], mesh.size)
    xs = _cut(mesh, x, bounds)
    ms = _cut(mesh, torch.as_tensor(mask).bool(), bounds)
    dev0 = mesh.devices[0]
    c = torch.as_tensor(centroids).to(dev0, torch.float32)
    assign = torch.zeros(sum(x.shape[0] for x in xs), dtype=torch.int32,
                         device=dev0)
    inertia = torch.tensor(float("inf"), dtype=torch.float32, device=dev0)

    def snapshot() -> Dict[str, np.ndarray]:
        return {"centroids": c.cpu().numpy().astype(np.float32),
                "iteration": np.int32(it)}

    it = start_iteration
    stepped = converged = cancelled = False
    while it < cfg.max_iters:
        if token is not None and token.cancelled():
            cancelled = True
            break
        assign, c, shift, inertia = step(xs, c, ms)
        stepped = True
        it += 1
        if on_state is not None and it % state_interval == 0:
            on_state(snapshot())
        if float(shift) < cfg.tol:
            converged = True
            break
    if not stepped and not cancelled:
        # resumed at (or past) the iteration ceiling: the checkpoint holds
        # centroids but no labels.  One step gives the assignment and
        # inertia of the incoming centroids (computed before the update).
        assign, _, _, inertia = step(xs, c, ms)
    result = kmeans.KMeansResult(
        centroids=c,
        labels=assign.to(torch.int16),
        inertia=inertia,
        iterations=torch.tensor(it, dtype=torch.int32),
        converged=torch.tensor(converged),
        cancelled=cancelled,
    )
    return result, (snapshot() if cancelled else None)


def sharded_dbscan_fit_resumable(
    mesh: Mesh,
    x_pad: ArrayLike,
    cfg: dbscan.DBSCANConfig,
    token: Optional[CancellationToken] = None,
    *,
    state: Optional[dbscan.DBSCANRunState] = None,
    valid_mask: Optional[ArrayLike] = None,
    on_state: Optional[Callable[[dbscan.DBSCANRunState], None]] = None,
    state_interval: int = 8,
    axis: str = "data",
) -> Tuple[dbscan.DBSCANResult, Optional[dbscan.DBSCANRunState]]:
    """DBSCAN host loop with the two O(n^2) kernels on the ring.

    The degree and every frontier expansion run as ring calls (p^2 cross
    launches each; the kernels for kernel configs, the plain versions
    otherwise); the O(n) bookkeeping, the paper's packed int16 word, stays
    on ``devices[0]`` in :func:`repro_torch.core.dbscan.expand_clusters`,
    which is what makes the state checkpointable and independent of the
    mesh's shape.  Same contract as :func:`repro_torch.core.dbscan.
    fit_resumable`, and the same labels.
    """
    degree_fn = make_ring_degree(mesh, cfg.eps, axis, cfg.use_kernel)
    expand_fn = make_ring_expand(mesh, cfg.eps, axis, cfg.use_kernel)
    xs = shard(mesh, torch.as_tensor(x_pad).float())
    deg = gather(mesh, degree_fn(xs))        # ring call 1 (degree)
    return dbscan.expand_clusters(
        deg, lambda frontier: gather(mesh, expand_fn(xs, frontier)), cfg,
        token, state=state, valid_mask=valid_mask, on_state=on_state,
        state_interval=state_interval)


# ---------------------------------------------------------------------------
# Dry-run entry: one distributed K-Means step
# ---------------------------------------------------------------------------


def clustering_step_for_dryrun(cfg: kmeans.KMeansConfig,
                               mesh: Optional[Mesh] = None):
    """``step(x, c) -> (assign, c_new, shift, inertia)``: one K-Means step
    over row-sharded points, the reference's dry-run function
    (``repro/core/distributed.py:clustering_step_for_dryrun``).

    It is :func:`make_sharded_kmeans_step` on ``mesh`` (by default the one
    device x lives on): with ``cfg.use_kernel`` on a CUDA mesh the fused
    step's two passes, bit for bit its one launch's result; on CPU tensors
    the plain version; on the meta device (``launch/dryrun_cluster.py``)
    the two passes' shape ops.  The shift is the sum of the centroids'
    absolute displacements, the inertia the sum of the squared distances
    (clamped at 0), as the reference's.  Unlike the reference, which
    shards the (n, k) scores over the centroids too ('model'), each shard
    holds every centroid.
    """

    def step(x, c):
        m = mesh if mesh is not None else Mesh((x.device,))
        return make_sharded_kmeans_step(m, cfg)(x, c)

    return step
