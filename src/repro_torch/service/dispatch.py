"""Paradigm registry + cost model — the paper's comparison as live dispatch.

The paper benchmarks the same two algorithms across competing paradigms
(GPU kernels vs. single/multi-threaded CPU) and finds the winner depends on
workload size: kernel launch + setup overhead buries small jobs, while
compiled/accelerated code wins at scale (Figs. 4-6).  Here that comparison
is a *runtime decision*: every batch is routed to one of four executors by
a work estimate (point count x feature dim x batch size), unless the
request pinned one explicitly.

    cuda-kernel   — the hand-written CUDA kernels (csrc/: the fused
                    Lloyd step, eps-degree, frontier expansion);
                    the paper's GPU paradigm
    torch-ref     — the plain PyTorch versions of the same steps;
                    the paper's compiled-code paradigm
    numpy-mt      — numpy across a thread pool over batch items;
                    the paper's multi-threaded CPU paradigm
    distributed   — one oversized request sharded over a mesh of local
                    devices (the row-sharded fused Lloyd step and the ring
                    DBSCAN of core/distributed.py, on the same kernels);
                    selected by the cost model when a request's working
                    set exceeds the per-device memory budget — the regime
                    every other paradigm would thrash or run out of
                    memory in.  A registry without it refuses such
                    requests at admission (``RequestTooLarge``).

Dispatch is a two-phase **plan/execute** contract.  ``Paradigm.plan``
returns an :class:`ExecutionPlan` — device placement, shard layout, padded
shapes, a fused-op cost estimate and a modeled-joules estimate — without
touching the data; ``Paradigm.execute`` runs a batch under that plan.  The
split means placement decisions are inspectable (plans ride in the durable
job record), resumable (a restarted host re-plans against its *own* device
topology), and energy-aware (the modeled-joules estimate feeds the
registry's tie-breaker, the paper's Fig. 9 as a control loop).

All device discovery goes through ``runtime.backend.discover_backend()`` —
the wrapper-library discipline: nothing here touches CUDA state at import
time.  Paradigms that run on a device take it at construction
(``"cuda"`` unless the caller asks for the CPU); each item's points move
there once, and results come back as numpy.

Executors run *items* (one request inside a padded batch) and report
completion and periodic mid-item state through callbacks, so the batch
executor can checkpoint and later resume a preempted batch without the
paradigm knowing how durability works.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import dbscan, kmeans
from repro_torch.runtime import backend as backend_mod
from repro_torch.service.energy import classify_work, device_class_for

EXECUTOR_CUDA = "cuda-kernel"
EXECUTOR_TORCH_REF = "torch-ref"
EXECUTOR_NUMPY_MT = "numpy-mt"
EXECUTOR_DISTRIBUTED = "distributed"

# Below this many fused ops, dispatch/launch overhead dominates and the
# multi-threaded host paradigm wins (the paper's small-workload regime).
SMALL_WORK_THRESHOLD = 1 << 21
_KMEANS_ITERS_ESTIMATE = 20

# Fraction of a device's HBM one request's working set may occupy before
# the cost model routes it to the distributed paradigm (the rest is
# headroom for the batch, compiled executables, and collective buffers).
DEVICE_BUDGET_FRACTION = 0.25

# Deprecated alias: the pre-refactor scalar prior (little-class J/work).
# Plans are now priced per device class via service/energy.py profiles —
# the little class's joules_per_work is bit-identical to the old
# 3.0 / 5e7 value, so historical callers see the same number.
from repro_torch.service.energy import LITTLE as _LITTLE_CLASS

DEFAULT_JOULES_PER_WORK = _LITTLE_CLASS.joules_per_work

# DBSCAN pad isolation: padded rows sit on a far diagonal in feature 0 so
# each pad is outside eps of every real point *and* of every other pad —
# they come out as noise and are sliced off.  One scheme shared by the
# batch executor (bucket padding) and the distributed paradigm (shard
# padding): the "pads can never be core/member/frontier" invariant that
# makes sharded state slicing lossless depends on both using it.
PAD_SPACING_FACTOR = 16.0


def far_diagonal_pad(out: np.ndarray, start: int, eps: float,
                     high: float) -> None:
    """Fill rows ``start:`` of ``out`` with the far-diagonal ladder, each
    row > eps from everything at or below ``high`` and from each other."""
    spacing = max(PAD_SPACING_FACTOR * eps, 1.0)
    out[start:, 0] = high + spacing * (1.0 + np.arange(out.shape[0] - start))


@dataclasses.dataclass
class ItemView:
    """One request inside a padded batch, as the paradigm sees it."""

    index: int
    x_pad: np.ndarray          # (n_max, d) — padding already applied
    length: int                # real point count
    seed: int
    mid_state: Optional[Dict[str, np.ndarray]] = None  # resume snapshot


@dataclasses.dataclass
class RunOutcome:
    """How a paradigm run ended.  ``item_index``/``mid_state`` identify the
    item that was mid-flight on suspension (None at an item boundary)."""

    suspended: bool = False
    item_index: Optional[int] = None
    mid_state: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class ExecutionPlan:
    """Phase one of dispatch: where and how a batch will run.

    ``devices``/``shards``/``shard_rows`` describe placement (single-device
    plans have ``shards == 1``); ``cost`` is the fused-op estimate the lane
    pool balances on; ``device_class`` names the simulated SoC cluster the
    paradigm executes on (``service/energy.py`` big/little profile) and
    ``modeled_joules`` is priced against that class (EWMA joules-per-work x
    cost when a measured hint exists, else the class's affine power model).
    ``config`` is the paradigm's private payload (the compiled-program
    config) and never serialises — :meth:`summary` is the JSON-able view
    stored in the durable job record.
    """

    paradigm: str
    algo: str
    params: Dict[str, Any]
    batch_size: int
    n_max: int                 # padded rows per item (the batcher's bucket)
    features: int
    devices: int = 1           # local devices the plan spans
    shards: int = 1            # shard count (1 = unsharded)
    shard_rows: int = 0        # padded rows per shard
    cost: float = 0.0          # fused-op estimate (dispatch cost model)
    device_class: str = ""     # energy.DEVICE_CLASSES key pricing the plan
    modeled_joules: float = 0.0
    config: Any = None         # paradigm-private; not serialised

    def summary(self) -> Dict[str, Any]:
        """JSON-able view for job records, outcomes, and metrics."""
        return {
            "paradigm": self.paradigm,
            "algo": self.algo,
            "batch_size": self.batch_size,
            "n_max": self.n_max,
            "features": self.features,
            "devices": self.devices,
            "shards": self.shards,
            "shard_rows": self.shard_rows,
            "cost": self.cost,
            "device_class": self.device_class,
            "modeled_joules": self.modeled_joules,
        }


ItemDone = Callable[[int, np.ndarray, Dict[str, Any]], None]
ItemState = Callable[[int, Dict[str, np.ndarray]], None]


def _cancelled(token) -> bool:
    return token is not None and token.cancelled()


class Paradigm:
    """Base executor: plans a batch's placement, then runs its items.

    The two phases are separable on purpose: the batch executor persists
    the plan summary before running, and a resumed job re-plans on the
    reattaching host (whose device topology may differ).
    """

    name: str = "abstract"
    resumable_mid_item: bool = False

    def plan(
        self,
        algo: str,
        params: Dict[str, Any],
        *,
        batch_size: int,
        n_max: int,
        features: int,
        energy_hint: Optional[float] = None,
    ) -> ExecutionPlan:
        """Default single-device plan; paradigms override placement."""
        cost = estimate_work(algo, n_max, features, batch_size, params)
        cls = device_class_for(self.name)
        # measured EWMA beats the static class model once batches exist
        joules = (energy_hint * cost if energy_hint is not None
                  else cls.modeled_joules(cost))
        return ExecutionPlan(
            paradigm=self.name,
            algo=algo,
            params=dict(params),
            batch_size=batch_size,
            n_max=n_max,
            features=features,
            devices=1,
            shards=1,
            shard_rows=n_max,
            cost=cost,
            device_class=cls.name,
            modeled_joules=joules,
            config=self._config(algo, params),
        )

    def _config(self, algo: str, params: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def execute(
        self,
        plan: ExecutionPlan,
        items: List[ItemView],
        token,
        on_item_done: ItemDone,
        on_item_state: ItemState,
        state_interval: int = 8,
        boundary_hook: Optional[Callable[[], List[ItemView]]] = None,
    ) -> RunOutcome:
        """Run the batch's items.  ``boundary_hook``, when given, is polled
        at iteration boundaries (continuous batching): it returns freshly
        joined :class:`ItemView`\\ s — already padded and slotted by the
        batch executor — which the paradigm must fold into the in-flight
        run.  Paradigms without iteration boundaries ignore it."""
        raise NotImplementedError


# how many Lloyd iterations between boundary-hook polls inside a quantum:
# joins are claimed on this cadence, checkpoints on the (coarser)
# state_interval one
_JOIN_POLL_ITERS = 8


class TorchParadigm(Paradigm):
    """Shared host-loop driver for the two device paradigms; they differ
    only in whether the CUDA kernels or the plain PyTorch versions run the
    math (the paper's 'same code, different device' portability story).

    ``device`` is where the items run (``"cuda"`` by default; the CPU only
    when asked, and there the kernel wrappers take their plain versions).
    """

    resumable_mid_item = True

    def __init__(self, name: str, use_kernel: bool,
                 device: "torch.device | str" = "cuda",
                 exec_cache=None) -> None:
        from repro_torch.service.exec_cache import default_exec_cache

        self.name = name
        self.use_kernel = use_kernel
        self.device = torch.device(device)
        # persistent step cache: prepared steps keyed by (algo, kind,
        # bucket shape, dim, params, device) — shared process-wide so every
        # lane and every batch with the same shape reuses one entry
        self.exec_cache = exec_cache or default_exec_cache()

    def _config(self, algo: str, params: Dict[str, Any]) -> Any:
        if algo == "dbscan":
            return _dbscan_config(params, use_kernel=self.use_kernel)
        return _kmeans_config(params, use_kernel=self.use_kernel)

    # -- DBSCAN --------------------------------------------------------------

    def _to_device(self, x_pad: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x_pad, np.float32),
                               device=self.device)

    def _valid_mask(self, item) -> torch.Tensor:
        return (torch.arange(item.x_pad.shape[0], device=self.device)
                < item.length)

    def _run_dbscan_item(self, item, cfg, token, on_item_done, on_item_state,
                         state_interval):
        state = (dbscan.DBSCANRunState.from_tree(item.mid_state)
                 if item.mid_state is not None else None)
        result, run_state = dbscan.fit_resumable(
            self._to_device(item.x_pad), cfg, token,
            state=state,
            valid_mask=self._valid_mask(item),
            on_state=lambda s: on_item_state(item.index, s.as_tree()),
            state_interval=state_interval,
        )
        if result.cancelled:
            assert run_state is not None
            return RunOutcome(suspended=True, item_index=item.index,
                              mid_state=run_state.as_tree())
        labels = result.labels.cpu().numpy()
        real = labels[: item.length]
        on_item_done(item.index, labels, {
            "n_clusters": int(real.max(initial=0)),
            "noise": int(np.sum(real == 0)),
            "expansions": int(result.expansions),
        })
        return RunOutcome()

    # -- K-Means -------------------------------------------------------------

    def _kmeans_slot(self, item, cfg):
        """Per-item runtime state for the Lloyd host loop (fresh or
        resumed from the item's checkpointed mid state)."""
        x_pad = self._to_device(item.x_pad)
        mask = self._valid_mask(item)
        if item.mid_state is not None:
            c = torch.as_tensor(
                np.asarray(item.mid_state["centroids"], np.float32),
                device=self.device)
            it = int(item.mid_state["iteration"])
        else:
            c = kmeans.init_centroids(item.seed, x_pad[: item.length], cfg)
            it = 0
        return {"item": item, "x": x_pad, "mask": mask, "c": c, "it": it,
                "assign": None, "inertia": float("inf"), "stepped": False}

    @staticmethod
    def _kmeans_mid(slot) -> Dict[str, np.ndarray]:
        return {"centroids": slot["c"].cpu().numpy().astype(np.float32),
                "iteration": np.int32(slot["it"])}

    def _kmeans_finish(self, slot, step, on_item_done, converged) -> None:
        if not slot["stepped"]:
            # resumed at the iteration ceiling: the checkpoint carries
            # centroids, not labels — recover the assignment of the
            # incoming centroids (computed before the update) rather than
            # completing with all-zero labels
            assign, _, _, inertia = step(slot["x"], slot["c"], slot["mask"])
            slot["assign"], slot["inertia"] = assign, inertia
        on_item_done(
            slot["item"].index,
            slot["assign"].cpu().numpy().astype(np.int16), {
                "inertia": float(slot["inertia"]),
                "iterations": slot["it"],
                "converged": bool(converged),
                "centroids": slot["c"].cpu().numpy().astype(np.float32),
            })

    def _run_kmeans_item(self, item, cfg, token, on_item_done, on_item_state,
                         state_interval):
        slot = self._kmeans_slot(item, cfg)
        step = self.exec_cache.kmeans_step(
            item.x_pad.shape[0], item.x_pad.shape[1], cfg, self.device)
        converged = False
        while slot["it"] < cfg.max_iters:
            if _cancelled(token):
                return RunOutcome(
                    suspended=True, item_index=item.index,
                    mid_state=self._kmeans_mid(slot))
            assign, c, shift, inertia = step(
                slot["x"], slot["c"], slot["mask"])
            slot["assign"], slot["c"], slot["inertia"] = assign, c, inertia
            slot["stepped"] = True
            slot["it"] += 1
            if slot["it"] % state_interval == 0:
                on_item_state(item.index, self._kmeans_mid(slot))
            if float(shift) < cfg.tol:
                converged = True
                break
        self._kmeans_finish(slot, step, on_item_done, converged)
        return RunOutcome()

    # -- continuous batching -------------------------------------------------

    def _execute_kmeans_continuous(self, plan, items, token, on_item_done,
                                   on_item_state, state_interval,
                                   boundary_hook):
        """Interleaved Lloyd driver: the continuous-batching hot loop.

        Every in-flight item runs a quantum of ``state_interval``
        iterations, then yields — converged items retire immediately
        (``on_item_done`` fires mid-batch, which is what resolves their
        futures early), and the boundary hook is polled so compatible
        queued requests join the run in freed slots without waiting for
        the batch to finish.  All items share one prepared step (same
        bucket shape), so joining never prepares another.
        """
        from collections import deque

        active = deque(self._kmeans_slot(item, plan.config)
                       for item in items)
        while active:
            if _cancelled(token):
                # snapshot EVERY mid-flight slot so the suspension
                # checkpoint covers the whole in-flight set, not just one
                for slot in active:
                    on_item_state(slot["item"].index, self._kmeans_mid(slot))
                return RunOutcome(suspended=True)
            slot = active.popleft()
            cfg = plan.config
            step = self.exec_cache.kmeans_step(
                slot["x"].shape[0], slot["x"].shape[1], cfg, self.device)
            converged = False
            quantum = 0
            while slot["it"] < cfg.max_iters and quantum < state_interval:
                assign, c, shift, inertia = step(
                    slot["x"], slot["c"], slot["mask"])
                slot["assign"], slot["c"] = assign, c
                slot["inertia"] = inertia
                slot["stepped"] = True
                slot["it"] += 1
                quantum += 1
                if float(shift) < cfg.tol:
                    converged = True
                    break
                # join sub-cadence: claim staged compatible requests every
                # few iterations, decoupled from the (much coarser)
                # checkpoint quantum — a joiner's wait is bounded by
                # iterations, not by how often state is persisted
                if (boundary_hook is not None
                        and quantum % _JOIN_POLL_ITERS == 0):
                    for joined in boundary_hook():
                        active.append(self._kmeans_slot(joined, cfg))
            if converged or slot["it"] >= cfg.max_iters:
                # early retirement: labels delivered before the batch ends
                self._kmeans_finish(slot, step, on_item_done, converged)
            else:
                on_item_state(slot["item"].index, self._kmeans_mid(slot))
                active.append(slot)
            if boundary_hook is not None:
                for joined in boundary_hook():
                    active.append(self._kmeans_slot(joined, cfg))
        return RunOutcome()

    def execute(self, plan, items, token, on_item_done, on_item_state,
                state_interval=8, boundary_hook=None):
        # lazy-load before first device use (raises without a card when
        # the paradigm runs on "cuda")
        backend_mod.discover_backend(self.device.type)
        cfg = plan.config if plan.config is not None else self._config(
            plan.algo, plan.params)
        if plan.config is None:
            plan = dataclasses.replace(plan, config=cfg)
        if plan.algo != "dbscan" and boundary_hook is not None:
            return self._execute_kmeans_continuous(
                plan, items, token, on_item_done, on_item_state,
                state_interval, boundary_hook)
        run_item = (self._run_dbscan_item if plan.algo == "dbscan"
                    else self._run_kmeans_item)
        from collections import deque

        work = deque(items)
        while work:
            if _cancelled(token):
                return RunOutcome(suspended=True)
            item = work.popleft()
            outcome = run_item(item, cfg, token, on_item_done, on_item_state,
                               state_interval)
            if outcome.suspended:
                return outcome
            if boundary_hook is not None:
                # DBSCAN expansion rounds have no shared quantum driver;
                # joins happen at item boundaries (retire is still early:
                # on_item_done fired per item above)
                work.extend(boundary_hook())
        return RunOutcome()


class NumpyMTParadigm(Paradigm):
    """Multi-threaded host paradigm: numpy per item, threads across items.

    Mid-item state is not checkpointable here (no step boundary to poll),
    so preemption is honoured at item boundaries: finished items land in
    the batch state, unfinished ones rerun on resume.
    """

    name = EXECUTOR_NUMPY_MT
    resumable_mid_item = False

    def __init__(self, max_workers: Optional[int] = None) -> None:
        import os

        self.max_workers = max_workers or min(8, os.cpu_count() or 1)

    def _config(self, algo: str, params: Dict[str, Any]) -> Any:
        if algo == "dbscan":
            return _dbscan_config(params, use_kernel=False)
        return _kmeans_config(params, use_kernel=False)

    @staticmethod
    def _dbscan_item(item: ItemView, cfg) -> tuple:
        x = np.asarray(item.x_pad[: item.length], np.float32)
        real = dbscan.fit_oracle(x, cfg)
        labels = np.zeros((item.x_pad.shape[0],), np.int16)
        labels[: item.length] = real.astype(np.int16)
        return labels, {
            "n_clusters": int(real.max(initial=0)),
            "noise": int(np.sum(real == 0)),
            "expansions": 0,
        }

    @staticmethod
    def _kmeans_item(item: ItemView, cfg) -> tuple:
        x = np.asarray(item.x_pad[: item.length], np.float32)
        # identical seeding across paradigms: results are paradigm-portable
        c = kmeans.init_centroids(item.seed, torch.from_numpy(x),
                                  cfg).numpy()
        it = 0
        converged = False
        assign = np.zeros((x.shape[0],), np.int64)
        inertia = float("inf")
        while it < cfg.max_iters:
            d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(1)
            inertia = float(d2.min(1).sum())
            c_new = c.copy()
            for j in range(cfg.k):
                m = assign == j
                if m.any():   # empty cluster keeps its center (paper)
                    c_new[j] = x[m].mean(0)
            shift = float(np.abs(c_new - c).sum())
            c = c_new
            it += 1
            if shift < cfg.tol:
                converged = True
                break
        labels = np.zeros((item.x_pad.shape[0],), np.int16)
        labels[: item.length] = assign.astype(np.int16)
        return labels, {
            "inertia": inertia,
            "iterations": it,
            "converged": converged,
            "centroids": c.astype(np.float32),
        }

    def execute(self, plan, items, token, on_item_done, on_item_state,
                state_interval=8, boundary_hook=None):
        # no iteration-boundary joins: the thread pool runs items to
        # completion, so a continuous hook is ignored (batcher re-forms)
        cfg = plan.config if plan.config is not None else self._config(
            plan.algo, plan.params)
        work = (self._dbscan_item if plan.algo == "dbscan"
                else self._kmeans_item)
        suspended = threading.Event()

        def run_one(item: ItemView):
            if _cancelled(token):
                suspended.set()
                return
            labels, scalars = work(item, cfg)
            if _cancelled(token):
                # completed anyway; still record it so resume skips the item
                suspended.set()
            on_item_done(item.index, labels, scalars)

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            list(pool.map(run_one, items))
        if suspended.is_set() or _cancelled(token):
            return RunOutcome(suspended=True)
        return RunOutcome()


class DistributedParadigm(Paradigm):
    """One oversized request sharded over a mesh of local devices.

    K-Means runs the row-sharded masked step
    (``distributed.make_sharded_masked_kmeans_step``): the item's rows cut
    at the fused step's blocks, each shard's through the fused kernel's
    pass 1 against the replicated centroids, every shard's partials added
    by pass 2 on the mesh's first device in block order — the
    ``cuda-kernel`` lane's step, bit for bit, at any shard count.
    DBSCAN runs the ring (``make_ring_degree`` / ``make_ring_expand``):
    each shard keeps its rows, the column shards rotate, and every step is
    a launch of the cross neighbour entry, so no (n, n) adjacency and no
    (n/p, n/p) tile is ever held.  Both loops poll the abort flag between
    launches and snapshot state gathered to the host that does not depend
    on the mesh's shape, so a job preempted mid-shard resumes on any mesh
    exactly like single-device jobs do.

    The reference runs this lane on its XLA math (GSPMD cannot partition a
    Pallas call); here the kernels run it (``use_kernel=True``).  ``mesh``
    defaults to :func:`~repro_torch.core.distributed.local_mesh` over
    ``device``'s local devices (one ``cuda:0`` on one H100); tests and the
    smoke pass a mesh that repeats one device to run p shards on it.
    """

    name = EXECUTOR_DISTRIBUTED
    resumable_mid_item = True

    def __init__(self, axis: str = "data",
                 device: "torch.device | str" = "cuda",
                 mesh=None) -> None:
        self.axis = axis
        self.device = torch.device(device)
        self._mesh = mesh

    def mesh(self):
        from repro_torch.core import distributed as dist

        if self._mesh is None:
            self._mesh = dist.local_mesh(self.axis, self.device.type)
        return self._mesh

    def _config(self, algo: str, params: Dict[str, Any]) -> Any:
        if algo == "dbscan":
            return _dbscan_config(params, use_kernel=True)
        return _kmeans_config(params, use_kernel=True)

    def plan(self, algo, params, *, batch_size, n_max, features,
             energy_hint=None):
        from repro_torch.core import distributed as dist

        mesh = self.mesh()
        shards = mesh.size
        if algo == "dbscan":
            rows = dist.shard_rows(n_max, shards)
        else:   # cut at the fused step's blocks, not padded
            rows = max(b - a for a, b in dist.kmeans_bounds(
                n_max, int(params.get("k", 8)), features, shards))
        cost = estimate_work(algo, n_max, features, batch_size, params)
        cls = device_class_for(self.name)
        joules = (energy_hint * cost if energy_hint is not None
                  else cls.modeled_joules(cost))
        return ExecutionPlan(
            paradigm=self.name,
            algo=algo,
            params=dict(params),
            batch_size=batch_size,
            n_max=n_max,
            features=features,
            devices=len(set(mesh.devices)),
            shards=shards,
            shard_rows=rows,
            cost=cost,
            device_class=cls.name,
            modeled_joules=joules,
            config=self._config(algo, params),
        )

    # -- shard padding -------------------------------------------------------

    @staticmethod
    def _pad_to_shards(x_pad: np.ndarray, plan: ExecutionPlan) -> np.ndarray:
        """Grow a DBSCAN item (n_max, d) to (shards * shard_rows, d) for
        even sharding.

        Extra rows continue the executor's far-diagonal pattern (each new
        pad sits beyond eps of every real point and every other pad), so
        they can never be core, member, or frontier — which is what makes
        slicing the state back to n_max lossless.  (K-Means items are not
        padded: their shards are cut at the fused step's blocks.)
        """
        n_pad = plan.shards * plan.shard_rows
        n_max = x_pad.shape[0]
        if n_pad <= n_max:
            return x_pad
        out = np.zeros((n_pad, x_pad.shape[1]), np.float32)
        out[:n_max] = x_pad
        high = float(np.max(x_pad)) if x_pad.size else 0.0
        far_diagonal_pad(out, n_max, float(plan.params.get("eps", 1.0)),
                         high)
        return out

    @staticmethod
    def _resize_dbscan_state(state: dbscan.DBSCANRunState,
                             n: int) -> dbscan.DBSCANRunState:
        """Slice or zero-extend per-point state to ``n`` rows.

        Rows beyond n_max are shard padding: never core, member, or in the
        frontier (see ``_pad_to_shards``), so both directions are lossless
        — a checkpoint written on one mesh resumes on another.
        """
        packed = np.zeros((n,), np.int16)
        frontier = np.zeros((n,), bool)
        m = min(n, state.packed.shape[0])
        packed[:m] = state.packed[:m]
        frontier[:m] = state.frontier[:m]
        return dbscan.DBSCANRunState(packed=packed, frontier=frontier,
                                     cid=state.cid, nexp=state.nexp)

    # -- items ---------------------------------------------------------------

    def _kmeans_item(self, mesh, plan, item, token, on_item_done,
                     on_item_state, state_interval):
        from repro_torch.core import distributed as dist

        cfg = plan.config
        n_max = item.x_pad.shape[0]
        mask = np.arange(n_max) < item.length
        if item.mid_state is not None:
            c0 = np.asarray(item.mid_state["centroids"], np.float32)
            it0 = int(item.mid_state["iteration"])
        else:
            # identical seeding to the single-device paradigms: an
            # oversized request's labels match the unsharded reference
            c0 = kmeans.init_centroids(
                item.seed,
                torch.as_tensor(item.x_pad[: item.length]).to(
                    mesh.devices[0]),
                cfg)
            it0 = 0
        result, mid = dist.sharded_kmeans_fit_resumable(
            mesh, item.x_pad, mask, cfg, token,
            centroids=c0, start_iteration=it0,
            on_state=lambda s: on_item_state(item.index, s),
            state_interval=state_interval,
        )
        if result.cancelled:
            return RunOutcome(suspended=True, item_index=item.index,
                              mid_state=mid)
        labels = result.labels.cpu().numpy().astype(np.int16)
        on_item_done(item.index, labels, {
            "inertia": float(result.inertia),
            "iterations": int(result.iterations),
            "converged": bool(result.converged),
            "centroids": result.centroids.cpu().numpy().astype(np.float32),
        })
        return RunOutcome()

    def _dbscan_item(self, mesh, plan, item, token, on_item_done,
                     on_item_state, state_interval):
        from repro_torch.core import distributed as dist

        cfg = plan.config
        n_max = item.x_pad.shape[0]
        x_sh = self._pad_to_shards(item.x_pad, plan)
        n_pad = x_sh.shape[0]
        state = None
        if item.mid_state is not None:
            state = self._resize_dbscan_state(
                dbscan.DBSCANRunState.from_tree(item.mid_state), n_pad)
        valid = np.arange(n_pad) < item.length

        def report(s: dbscan.DBSCANRunState) -> None:
            # checkpoints carry the (n_max,) view — mesh-shape independent
            on_item_state(item.index,
                          self._resize_dbscan_state(s, n_max).as_tree())

        result, run_state = dist.sharded_dbscan_fit_resumable(
            mesh, x_sh, cfg, token,
            state=state, valid_mask=valid,
            on_state=report, state_interval=state_interval,
            axis=self.axis,
        )
        if result.cancelled:
            assert run_state is not None
            return RunOutcome(
                suspended=True, item_index=item.index,
                mid_state=self._resize_dbscan_state(
                    run_state, n_max).as_tree())
        labels = result.labels[:n_max].cpu().numpy().astype(np.int16)
        real = labels[: item.length]
        on_item_done(item.index, labels, {
            "n_clusters": int(real.max(initial=0)),
            "noise": int(np.sum(real == 0)),
            "expansions": int(result.expansions),
        })
        return RunOutcome()

    def execute(self, plan, items, token, on_item_done, on_item_state,
                state_interval=8, boundary_hook=None):
        # oversized requests run one at a time across the mesh; nothing
        # can share it, so boundary joins don't apply.  Discovery raises
        # without a card when the lane runs on "cuda".
        backend_mod.discover_backend(self.device.type)
        mesh = self.mesh()
        if plan.config is None:
            plan = dataclasses.replace(
                plan, config=self._config(plan.algo, plan.params))
        run_item = (self._dbscan_item if plan.algo == "dbscan"
                    else self._kmeans_item)
        for item in items:
            if _cancelled(token):
                return RunOutcome(suspended=True)
            outcome = run_item(mesh, plan, item, token, on_item_done,
                               on_item_state, state_interval)
            if outcome.suspended:
                return outcome
        return RunOutcome()


# -- config plumbing ---------------------------------------------------------


def _dbscan_config(params: Dict[str, Any], *, use_kernel: bool):
    return dbscan.DBSCANConfig(
        eps=float(params["eps"]),
        min_pts=int(params["min_pts"]),
        use_kernel=use_kernel,
    )


def _kmeans_config(params: Dict[str, Any], *, use_kernel: bool):
    return kmeans.KMeansConfig(
        k=int(params["k"]),
        max_iters=int(params.get("max_iters", kmeans.PAPER_MAX_ITERS)),
        tol=float(params.get("tol", kmeans.PAPER_TOL)),
        init=str(params.get("init", "sample")),
        use_kernel=use_kernel,
    )


# -- registry + cost model ---------------------------------------------------


def estimate_work(algo: str, n: int, d: int, batch_size: int,
                  params: Dict[str, Any]) -> float:
    """Fused-op estimate for one batch (the dispatch cost model input)."""
    if algo == "dbscan":
        per_item = float(n) * n * d          # O(n^2 d) adjacency dominates
    else:
        k = int(params.get("k", 8))
        per_item = float(n) * k * d * _KMEANS_ITERS_ESTIMATE
    return per_item * batch_size


def estimate_item_bytes(algo: str, n: int, d: int,
                        params: Dict[str, Any]) -> float:
    """Peak single-device working set of ONE request (the budget input).

    DBSCAN is dominated by the (n, n) f32 distance intermediate of the
    degree/expansion kernels; K-Means by the points, the (n, k) one-hot,
    and the per-point temporaries.  Deliberately rough — it only has to
    rank 'fits one device' vs 'does not'.
    """
    if algo == "dbscan":
        return 4.0 * float(n) * n + 8.0 * float(n) * d
    k = int(params.get("k", 8))
    return 8.0 * float(n) * d + 4.0 * float(n) * k + 16.0 * float(n)


class ParadigmRegistry:
    """Name -> paradigm map plus the two-stage cost model.

    ``device_budget_bytes`` bounds one request's working set on a single
    device; None derives it from the discovered chip
    (``DEVICE_BUDGET_FRACTION`` of its memory).  A request over budget is
    routed to the distributed paradigm when one is registered.  ``device``
    is the device the registry's paradigms run on (its chip sets the
    budget and the CUDA-first lane order).
    """

    def __init__(self,
                 device_budget_bytes: Optional[float] = None,
                 device: str = "cuda") -> None:
        self._paradigms: Dict[str, Paradigm] = {}
        self.device_budget_bytes = device_budget_bytes
        self.device = device

    def register(self, paradigm: Paradigm) -> None:
        self._paradigms[paradigm.name] = paradigm

    def get(self, name: str) -> Paradigm:
        try:
            return self._paradigms[name]
        except KeyError:
            raise KeyError(
                f"unknown executor {name!r}; registered: {self.names()}"
            ) from None

    def names(self) -> List[str]:
        return sorted(self._paradigms)

    # -- memory budget -------------------------------------------------------

    def budget_bytes(self) -> float:
        if self.device_budget_bytes is not None:
            return float(self.device_budget_bytes)
        chip = backend_mod.discover_backend(self.device).chip
        return DEVICE_BUDGET_FRACTION * chip.memory_bytes

    def oversized(self, algo: str, n: int, d: int,
                  params: Dict[str, Any],
                  bucket: Optional[Callable[[int], int]] = None) -> bool:
        """Does one request's working set exceed the per-device budget?

        The budget is judged at the *bucket* the request will pad to, not
        the raw point count — execution pads to the bucket, and for
        DBSCAN the (n_max, n_max) intermediate makes that up to a 4x
        difference.  ``bucket`` should be the owning service's policy
        view (its ``bucket_ceiling`` for admission screens, or an
        already-padded ``n`` with the identity-on-buckets ``bucket``).
        The pow2 default is exact for the ``pow2`` policy and an upper
        bound for ``adaptive`` (whose buckets are clamped at pow2), but
        it UNDER-prices a linear policy whose step exceeds the pow2
        bucket — such callers must pass their own ``bucket``.
        """
        from repro_torch.service.bucketing import pow2_bucket

        n_max = (bucket or pow2_bucket)(n)
        return (estimate_item_bytes(algo, n_max, d, params)
                > self.budget_bytes())

    # -- selection -----------------------------------------------------------

    def select(
        self,
        algo: str,
        n: int,
        d: int,
        batch_size: int,
        params: Dict[str, Any],
        explicit: Optional[str] = None,
        energy_hints: Optional[Dict[str, float]] = None,
        bucket: Optional[Callable[[int], int]] = None,
    ) -> str:
        """Cost-model dispatch (explicit override wins, and is validated)."""
        return self.candidates(algo, n, d, batch_size, params,
                               explicit=explicit,
                               energy_hints=energy_hints,
                               bucket=bucket)[0]

    def candidates(
        self,
        algo: str,
        n: int,
        d: int,
        batch_size: int,
        params: Dict[str, Any],
        explicit: Optional[str] = None,
        energy_hints: Optional[Dict[str, float]] = None,
        bucket: Optional[Callable[[int], int]] = None,
    ) -> List[str]:
        """Compatible executors in cost-model preference order.

        The first entry is what :meth:`select` returns; the rest are lanes
        the executor pool may spill to when the preferred lane is loaded
        (e.g. both device paradigms can take large batches — the pool picks
        the least-loaded of them).  An explicit override is a single-entry
        list: a pinned request never rides another lane.  A request whose
        working set exceeds the per-device budget has exactly one home:
        the distributed paradigm (no caller opt-in, no spill lanes).
        Selection reasons about (paradigm x device class): each paradigm
        executes on a simulated big/little SoC cluster
        (``service/energy.py``), and the energy-optimal class for the
        work size — little below the big class's crossover, where its
        dispatch overhead dominates — gates which paradigms compete.
        ``energy_hints`` (EWMA modeled joules per unit work, from
        :class:`repro_torch.service.metrics.ServiceMetrics`) then tie-break the
        surviving candidates toward the measured-cheaper paradigm — the
        paper's Fig. 9 energy comparison closed into a control loop.
        ``bucket`` (the service's bucket policy) decides the padded shape
        the budget check prices; pow2 by default.
        """
        if explicit is not None:
            self.get(explicit)
            return [explicit]
        if (EXECUTOR_DISTRIBUTED in self._paradigms
                and self.oversized(algo, n, d, params, bucket=bucket)):
            return [EXECUTOR_DISTRIBUTED]
        # the distributed lane exists *for* oversized requests; it never
        # competes for work that fits one device
        pool = [nm for nm in self._paradigms if nm != EXECUTOR_DISTRIBUTED]
        work = estimate_work(algo, n, d, batch_size, params)
        if classify_work(work).name == "little":
            little = sorted(nm for nm in pool
                            if device_class_for(nm).name == "little")
            return little or sorted(pool) or self.names()
        backend = backend_mod.discover_backend(self.device)
        accel = ([EXECUTOR_CUDA, EXECUTOR_TORCH_REF] if backend.is_cuda
                 else [EXECUTOR_TORCH_REF, EXECUTOR_CUDA])
        out = [name for name in accel if name in pool]
        if (energy_hints and len(out) > 1
                and all(name in energy_hints for name in out)):
            out = sorted(out, key=lambda name: energy_hints[name])
        return out or sorted(pool) or self.names()


def default_registry(
        device_budget_bytes: Optional[float] = None,
        device: str = "cuda") -> ParadigmRegistry:
    reg = ParadigmRegistry(device_budget_bytes=device_budget_bytes,
                           device=device)
    reg.register(TorchParadigm(EXECUTOR_CUDA, use_kernel=True, device=device))
    reg.register(TorchParadigm(EXECUTOR_TORCH_REF, use_kernel=False,
                               device=device))
    reg.register(NumpyMTParadigm())
    reg.register(DistributedParadigm(device=device))
    return reg
