"""DBSCAN — non-recursive, kernel-backed, preemption-safe.

Paper semantics (§II.C):
- non-recursive formulation ("it is not possible to use recursion with
  OpenCL") — here a host loop replaces the paper's explicit work list;
- two accelerator kernels "that have almost the same purpose": core-point
  reachability in the main loop and cluster expansion — here
  :func:`repro_torch.kernels.neighbor.epsilon_degree` and
  :func:`repro_torch.kernels.neighbor.expand_frontier` (``csrc/neighbor.cu``);
- defaults: min_pts = 10 x features, eps = sqrt(features);
- per-point bookkeeping in one int16 word: "the first three bits indicate if
  the data item has been visited and the density reachability.  The other
  bits are used to store the cluster number (0 equals to noise).  The first
  three bits are deleted before the algorithm finishes."  Implemented
  verbatim in :func:`pack_state` / :func:`unpack_state` / :func:`finish`.

Cluster ids are assigned in discovery order with the lowest-index unvisited
core point as the next seed, so the partition — including contended border
points, which go to the earliest-discovered cluster — is deterministic and
bit-identical to the sequential oracle and to the reference package.

A whole frontier expands per kernel launch, so the number of launches per
cluster is its BFS depth, not its point count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cancellation import CancellationToken
from repro_torch.kernels.neighbor.ops import epsilon_degree, expand_frontier
from repro_torch.kernels.neighbor.ref import (
    epsilon_degree_ref,
    expand_frontier_ref,
)
from repro_torch.runtime import spans

# --- the paper's int16 state word ------------------------------------------

VISITED_BIT = 0x1     # bit 0: visited
REACHABLE_BIT = 0x2   # bit 1: density-reachable (member of some cluster)
CORE_BIT = 0x4        # bit 2: core point
FLAG_MASK = 0x7
CLUSTER_SHIFT = 3     # cluster id lives in bits 3..15; 0 = noise

# Largest cluster id the packed int16 word can carry: bit 15 is the sign
# bit, so ids occupy bits 3..14 — 4095 clusters.  Beyond that, `labels <<
# CLUSTER_SHIFT` wraps negative and silently corrupts every later unpack.
MAX_CLUSTER_ID = np.iinfo(np.int16).max >> CLUSTER_SHIFT


def pack_state(labels: torch.Tensor, visited: torch.Tensor,
               member: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Pack per-point state into the paper's int16 word."""
    mx = int(spans.read(labels.max())) if labels.numel() else 0
    if mx > MAX_CLUSTER_ID:
        raise ValueError(
            f"cluster id {mx} does not fit the paper's int16 state word "
            f"(bits {CLUSTER_SHIFT}..14 hold the cluster number, so at "
            f"most {MAX_CLUSTER_ID} clusters are representable); "
            f"shard the dataset or raise min_pts/eps"
        )
    word = labels.to(torch.int32) << CLUSTER_SHIFT
    word = word | (visited.to(torch.int32) * VISITED_BIT)
    word = word | (member.to(torch.int32) * REACHABLE_BIT)
    word = word | (core.to(torch.int32) * CORE_BIT)
    return word.to(torch.int16)


def unpack_state(word: torch.Tensor):
    w = word.to(torch.int32)
    labels = w >> CLUSTER_SHIFT
    return (
        labels,
        (w & VISITED_BIT) > 0,
        (w & REACHABLE_BIT) > 0,
        (w & CORE_BIT) > 0,
    )


def finish(word: torch.Tensor) -> torch.Tensor:
    """Paper: 'The first three bits are deleted before the algorithm
    finishes' — returns plain cluster ids (0 = noise)."""
    return ((word.to(torch.int32) & ~FLAG_MASK) >> CLUSTER_SHIFT).to(
        torch.int16)


# --- configuration -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DBSCANConfig:
    eps: float
    min_pts: int
    use_kernel: bool = True

    @staticmethod
    def paper_defaults(features: int) -> "DBSCANConfig":
        return DBSCANConfig(
            eps=float(np.sqrt(features)), min_pts=10 * features
        )


@dataclasses.dataclass
class DBSCANResult:
    labels: torch.Tensor       # (n,) int16, 0 = noise, clusters 1..C
    core_mask: torch.Tensor    # (n,) bool
    n_clusters: torch.Tensor   # () i32
    expansions: torch.Tensor   # () i32 — number of expansion-kernel launches
    cancelled: bool = False


def _degree(x, cfg: DBSCANConfig):
    if cfg.use_kernel:
        return epsilon_degree(x, cfg.eps)
    return epsilon_degree_ref(x, cfg.eps)


def _expand(x, frontier, cfg: DBSCANConfig):
    if cfg.use_kernel:
        return expand_frontier(x, frontier, cfg.eps)
    return expand_frontier_ref(x, frontier, cfg.eps)


def fit(x: torch.Tensor, cfg: DBSCANConfig) -> DBSCANResult:
    """DBSCAN to completion (host loop, no cancellation)."""
    result, _ = fit_resumable(x, cfg)
    return result


# --- host-driven, cancellable + resumable solver ----------------------------


@dataclasses.dataclass
class DBSCANRunState:
    """Preemption snapshot of a host-driven run.

    ``packed`` is the paper's int16 word (labels + visited/member/core bits);
    ``frontier`` is the pending BFS frontier of the cluster being expanded
    when the run was interrupted (all-False at a cluster boundary).  Held as
    host numpy so it can be checkpointed without touching device state; the
    tree form is the reference package's, so a snapshot from either package
    resumes in the other (see :mod:`repro_torch.convert`).
    """

    packed: np.ndarray    # (n,) int16
    frontier: np.ndarray  # (n,) bool
    cid: int
    nexp: int

    def as_tree(self) -> dict:
        return {
            "packed": np.asarray(self.packed, np.int16),
            "frontier": np.asarray(self.frontier, bool),
            "cid": np.int32(self.cid),
            "nexp": np.int32(self.nexp),
        }

    @staticmethod
    def from_tree(tree: dict) -> "DBSCANRunState":
        return DBSCANRunState(
            packed=np.asarray(tree["packed"], np.int16),
            frontier=np.asarray(tree["frontier"], bool),
            cid=int(tree["cid"]),
            nexp=int(tree["nexp"]),
        )


def fit_resumable(
    x: torch.Tensor,
    cfg: DBSCANConfig,
    token: Optional[CancellationToken] = None,
    *,
    state: Optional[DBSCANRunState] = None,
    valid_mask: Optional[torch.Tensor] = None,
    on_progress: Optional[Callable[[int, int], None]] = None,
    on_state: Optional[Callable[[DBSCANRunState], None]] = None,
    state_interval: int = 8,
) -> Tuple[DBSCANResult, Optional[DBSCANRunState]]:
    """Host loop; the abort flag is polled between kernel executions, exactly
    as in the paper.  State is carried in the paper's packed int16 word.

    ``state`` resumes a previously interrupted run mid-BFS; on cancellation
    the returned second element is the snapshot to resume from (``None`` on
    normal completion).  ``on_state`` is invoked with a snapshot every
    ``state_interval`` expansions — the periodic-checkpoint hook.
    ``valid_mask`` marks real rows in a padded array: masked-out rows can
    never be core points (with min_pts=1 an isolated pad row would
    otherwise seed a phantom singleton cluster).
    """
    with spans.span("repro_torch.dbscan.fit"):
        deg = _degree(x, cfg)        # kernel launch 1 (main loop kernel)
        return expand_clusters(
            deg, lambda frontier: _expand(x, frontier, cfg), cfg, token,
            state=state, valid_mask=valid_mask, on_progress=on_progress,
            on_state=on_state, state_interval=state_interval)


def expand_clusters(
    deg: torch.Tensor,
    expand: Callable[[torch.Tensor], torch.Tensor],
    cfg: DBSCANConfig,
    token: Optional[CancellationToken] = None,
    *,
    state: Optional[DBSCANRunState] = None,
    valid_mask: Optional[torch.Tensor] = None,
    on_progress: Optional[Callable[[int, int], None]] = None,
    on_state: Optional[Callable[[DBSCANRunState], None]] = None,
    state_interval: int = 8,
) -> Tuple[DBSCANResult, Optional[DBSCANRunState]]:
    """:func:`fit_resumable`'s BFS host loop, from the points' eps-degrees
    ``deg`` (n,) and ``expand(frontier) -> reached``, one expansion launch
    a call (the distributed lane passes its ring's).  Same arguments and
    result as :func:`fit_resumable`; the state lives on ``deg``'s device.
    """
    n = deg.shape[0]
    dev = deg.device
    core = deg >= cfg.min_pts
    if valid_mask is not None:
        core = core & torch.as_tensor(valid_mask, dtype=torch.bool, device=dev)

    if state is not None:
        if state.packed.shape != (n,) or state.frontier.shape != (n,):
            raise ValueError(
                f"run state is for {state.packed.shape[0]} points, x has {n}")
        labels, visited, member, _ = unpack_state(
            torch.tensor(state.packed, device=dev))
        frontier = torch.tensor(state.frontier, device=dev)
        cid = int(state.cid)
        nexp = int(state.nexp)
    else:
        labels = torch.zeros((n,), dtype=torch.int32, device=dev)
        visited = torch.zeros((n,), dtype=torch.bool, device=dev)
        member = torch.zeros((n,), dtype=torch.bool, device=dev)
        frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
        cid = 0
        nexp = 0
    cancelled = False

    def _poll() -> bool:
        return token is not None and token.cancelled()

    def _snapshot() -> DBSCANRunState:
        return DBSCANRunState(
            packed=pack_state(labels, visited, member, core).cpu().numpy(),
            frontier=frontier.cpu().numpy(),
            cid=cid,
            nexp=nexp,
        )

    while True:
        # inner: expand the in-flight cluster's frontier to exhaustion
        while size := spans.read(frontier.sum()):
            if _poll():
                cancelled = True
                break
            with spans.span("repro_torch.dbscan.expand"):
                spans.count("frontier_points", size)
                reached = expand(frontier)  # expansion kernel launch
                nexp += 1
                new = reached & (labels == 0)
                labels = torch.where(new, cid, labels)
                visited = visited | new
                member = member | new
                frontier = new & core
            if on_progress is not None:
                on_progress(cid, nexp)
            if on_state is not None and nexp % state_interval == 0:
                on_state(_snapshot())
        if cancelled:
            break
        if _poll():
            cancelled = True
            break
        # outer: seed the next cluster at the lowest-index unvisited core pt
        with spans.span("repro_torch.dbscan.seed"):
            todo = core & ~visited
            if not spans.read(todo.any()):
                break
            cid += 1
            if cid > MAX_CLUSTER_ID:
                raise ValueError(
                    f"dataset produced more than {MAX_CLUSTER_ID} clusters — "
                    f"the paper's int16 state word cannot represent cluster "
                    f"id {cid}"
                )
            frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
            # the first True: indexing reads a 0-d index to the host, and
            # True is copied from the host, a copy that waits on the card
            first = spans.read(torch.argmax(todo.to(torch.uint8)))
            spans.synced(frontier.__setitem__, first, True)

    with spans.span("repro_torch.dbscan.finish"):
        packed = pack_state(labels, visited, member, core)
        result = DBSCANResult(
            labels=finish(packed),
            core_mask=core,
            n_clusters=torch.tensor(cid, dtype=torch.int32),
            expansions=torch.tensor(nexp, dtype=torch.int32),
            cancelled=cancelled,
        )
    return result, (_snapshot() if cancelled else None)


def fit_cancellable(
    x: torch.Tensor,
    cfg: DBSCANConfig,
    token: Optional[CancellationToken] = None,
    on_progress: Optional[Callable[[int, int], None]] = None,
) -> DBSCANResult:
    """Cancellable host loop (see :func:`fit_resumable` for the state API)."""
    result, _ = fit_resumable(x, cfg, token, on_progress=on_progress)
    return result


# --- sequential oracle (numpy BFS; used by tests) ----------------------------


def fit_oracle(x: np.ndarray, cfg: DBSCANConfig) -> np.ndarray:
    """Textbook sequential DBSCAN with the same seed ordering.  O(n^2)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    adj = d2 <= cfg.eps ** 2
    core = adj.sum(1) >= cfg.min_pts
    labels = np.zeros(n, np.int32)
    visited = np.zeros(n, bool)
    cid = 0
    for seed in range(n):
        if not core[seed] or visited[seed]:
            continue
        cid += 1
        frontier = np.zeros(n, bool)
        frontier[seed] = True
        while frontier.any():
            reached = (adj & frontier[None, :]).any(1)
            new = reached & (labels == 0)
            labels[new] = cid
            visited |= new
            frontier = new & core
    return labels
