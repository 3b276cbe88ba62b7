"""Public wrapper around the K-Means assignment kernel (``csrc/distance.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel on the current stream or raises — there is no fallback.
``assign_clusters.launches`` counts kernel launches (plain runs do not
count), so a run can show that its main path went through the kernel;
``assign_clusters.recheck_stats`` holds the last launch's count of exact
rechecks (:func:`rechecks` reads it).

:func:`plan` sizes a launch of this kernel and of the fused step
(``csrc/fused.cu``), which share the search in ``csrc/assign_common.cuh``:
rows per staged tile, centroids per packed chunk, whether every chunk stays
in shared memory, whether rows are wide enough for the wide search
(``search_wide_kernel``, or ``exact_wide_kernel`` for k <= 8) and its ring,
and the grids, all from (n, k, d) alone; the TF32 form's persistent grid
is capped at the card's SMs when it launches (:func:`search_grid`).
The byte sizes it plans with (:func:`assign_bytes`, :func:`fused_bytes`)
restate the header's layout; every launch holds them to the library's own
count and raises if the two differ.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance.ref import (
    add_point_norms,
    assign_clusters_ref,
    assign_scores_ref,
    pairwise_sq_dists_ref,
)

# A block's shared memory: 227 KB on Hopper.
MAX_SMEM = 232448
# What the plan gives the x ring (at two stages) and the centroid chunks.
_RING_BYTES = 80 * 1024
_CHUNK_BYTES = 32 * 1024
_RESIDENT_BYTES = 64 * 1024
# The ring's alignment slack and its mbarriers (kStages of 8 bytes).
_SLACK_BYTES = 1024
_BARRIER_BYTES = 16
# Rows wider than this take the wide search.  On an H100 (chip_smoke.py's
# "search forms" rows, n 65,536, k 64; PERF.md) it is 1.7x / 2.0x
# faster than the staged search at d 128 (assignment / fused step) and
# 3.4x / 4.5x at d 192, and the staged one cannot hold rows of 1,024
# features; at d 96 the wide search is faster too (0.0749 vs 0.1017 ms,
# 0.1402 vs 0.1538 ms).  The switch stays at 96 all the same: below it the
# staged plan fixes the fused step's partial blocks (block_rows) and so the
# bits of the one-job and service paths, and where below 96 the wide
# search starts to win is not measured.
WIDE_D = 96
# The wide search (csrc/assign_common.cuh, item 5): the fused step's sums
# take tiles of _WIDE_TM rows (kWideTM); the TF32 form's tiles hold
# _WIDE_ROWS points (kWideRows) and its ring up to _WIDE_MAX_STAGES box
# steps; k <= _EXACT_K takes the exact form, _EXACT_THREADS a block.
_WIDE_TM = 64
_WIDE_ROWS = 128
_WIDE_MAX_STAGES = 8
_EXACT_K = 8
_EXACT_THREADS = 64
# At most this many blocks: each owns a run of whole tiles.
MAX_BLOCKS = 1024

__all__ = ["assign_bytes", "assign_clusters", "assign_clusters_ref",
           "fused_bytes", "pairwise_sq_dists", "plan", "rechecks",
           "search_grid", "sums_bytes", "wide_bytes"]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "assign_clusters": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P, _P, _P, _P], ctypes.c_int),
    "assign_smem_bytes": ([_I, _I, _I, _I, _I, _I, _I], ctypes.c_size_t),
    "centroid_pack_floats": ([_I, _I, _I], ctypes.c_size_t),
}


class Plan(NamedTuple):
    tm: int               # points per staged tile (a multiple of 16); wide
                          # rows: _WIDE_TM, the fused step's sums' tile
    nt: int               # 8-centroid groups per packed chunk: 1, 2, 4, 8
    resident: bool        # every chunk stays in shared memory
    tiles_per_block: int  # (wide rows: of the fused step's sums)
    blocks: int           # (wide rows: the fused step's partial blocks)
    slots: int            # chunks held in shared memory at once
    wide: bool            # d > WIDE_D: the wide search
    stages: int = 0       # wide rows: the TF32 form's ring; 0 the exact form
    xres: bool = False    # wide rows: x's tile stays in shared memory
    search_blocks: int = 0  # wide rows: the search's blocks (the TF32
                            # form: its 128-point tiles; search_grid)


def _ksteps(d: int) -> int:
    return -(-d // 8)


def boxes(d: int) -> int:
    """32-column boxes of a row padded to a multiple of 8 features."""
    return -(-8 * _ksteps(d) // 32)


def chunk_bytes(d: int, nt: int) -> int:
    """Bytes of one packed chunk of 8 nt centroids (chunk_floats): two
    TF32 images, exact rows, norms, trailer, rounded up to 1024."""
    kc = 8 * nt
    floats = 2 * boxes(d) * kc * 32 + kc * (8 * _ksteps(d) + 4) + kc + 4
    return 4 * (-(-floats // 256) * 256)


def stage_bytes(d: int, tm: int) -> int:
    """Bytes of one staged tile: 32-column boxes of 128-byte rows."""
    return boxes(d) * tm * 128


def wide_bytes(d: int, nt: int, stages: int, xres: bool) -> int:
    """Shared memory of a wide-search block (wide_smem_bytes): alignment
    slack, x's resident tile as TF32 hi and lo images (128-row boxes), the
    ring of box steps (x's box unless resident, the chunk's hi and lo
    boxes), 2 stages + 2 mbarriers, each tile row's best key (8 bytes) and
    recheck count (4); 0 for the exact form."""
    if stages == 0:
        return 0
    xtile = 2 * boxes(d) * _WIDE_ROWS * 128 if xres else 0
    stage = (0 if xres else _WIDE_ROWS * 128) + 16 * nt * 128
    return (_SLACK_BYTES + xtile + stages * stage + 8 * (2 * stages + 2)
            + 12 * _WIDE_ROWS)


def assign_bytes(d: int, p: Plan) -> int:
    """Shared memory of an assignment block (assign_smem_bytes): the
    ring and the chunk slots, alignment slack, mbarriers; for wide rows
    :func:`wide_bytes`."""
    if p.wide:
        return wide_bytes(d, p.nt, p.stages, p.xres)
    body = 2 * stage_bytes(d, p.tm) + p.slots * chunk_bytes(d, p.nt)
    return _SLACK_BYTES + body + _BARRIER_BYTES


def acc_floats(d: int, tm: int, acc_k: int) -> int:
    """The fused step's sums, counts and row arrays, kept even (fused.cu)."""
    f = acc_k * d + acc_k + 3 * tm
    return f + (f & 1)


def sums_bytes(d: int, acc_k: int) -> int:
    """Shared memory of the wide rows' sums kernel (sums_smem_bytes):
    acc_k centroids' sums and counts, two warps' inertia."""
    return 4 * (acc_k * d + acc_k) + 16


def fused_bytes(d: int, p: Plan, acc_k: int) -> int:
    """Shared memory of a fused-step block (fused_smem_bytes); for wide rows
    the sums kernel's (the search's is :func:`assign_bytes`)."""
    if p.wide:
        return sums_bytes(d, acc_k)
    return assign_bytes(d, p) + 4 * acc_floats(d, p.tm, acc_k)


def _wide_search(n: int, k: int, d: int) -> Tuple[int, int, bool, int]:
    """(nt, stages, xres, search_blocks) of the wide search."""
    if k <= _EXACT_K:  # every pair exact: lanes of a block, a pair each
        kp = 1 << (k - 1).bit_length()
        return 1, 0, False, -(-n * kp // _EXACT_THREADS)
    nt = 8
    while nt > 1 and 8 * (nt // 2) >= k:
        nt //= 2
    # x's tile stays while the chunks go by, where there are several and
    # it fits beside a ring of two; else its boxes ride the ring
    xres = (-(-k // (8 * nt)) > 1
            and wide_bytes(d, nt, 2, True) <= MAX_SMEM)
    stages = _WIDE_MAX_STAGES
    while stages > 2 and wide_bytes(d, nt, stages, xres) > MAX_SMEM:
        stages -= 1
    return nt, stages, xres, -(-n // _WIDE_ROWS)


def plan(n: int, k: int, d: int, max_blocks: int = MAX_BLOCKS) -> Plan:
    """How a search over (n, k, d) is launched; a function of the shape
    alone, so a fused step always sums in the same order.

    Up to WIDE_D features: tiles of up to 128 whole rows in a 2-stage
    ring, chunks of up to 64 centroids resident or staged one at a time;
    blocks of tiles_per_block tiles, which are the fused step's partial
    blocks.  Wider rows: the wide search, bound by its three TF32
    products: search_blocks tiles of 128 points, walked by a persistent
    grid of at most one block an SM (:func:`search_grid`), against chunks
    of up to 64 centroids (nt) streamed a 32-column box at a time through
    a ring of ``stages`` box steps, x's tile resident across the chunks
    when there are several and it fits (xres); or, for k <= 8, the exact
    form (stages 0), every pair scored exactly, search_blocks blocks of
    64 lanes, a lane a (point, centroid) pair (at the embedding fit's
    shape it is bound by each lane's chain of d adds, and takes a third
    of the TF32 form's time).  The fused step's sums then take partial
    blocks of tiles_per_block tiles of 64 rows (block_rows), as the first
    wide form's did.
    """
    if d > WIDE_D:
        nt, stages, xres, search_blocks = _wide_search(n, k, d)
        tiles = -(-n // _WIDE_TM)
        tiles_per_block = -(-tiles // max(1, max_blocks))
        return Plan(_WIDE_TM, nt, False, tiles_per_block,
                    -(-tiles // tiles_per_block), 0, True, stages, xres,
                    search_blocks)
    nt = 8
    tm = 128
    while tm > 16 and 2 * stage_bytes(d, tm) > _RING_BYTES:
        tm //= 2
    while nt > 1 and (8 * (nt // 2) >= k
                      or chunk_bytes(d, nt) > _CHUNK_BYTES):
        nt //= 2
    chunks = -(-k // (8 * nt))
    resident = chunks * chunk_bytes(d, nt) <= _RESIDENT_BYTES
    slots = chunks if resident else 1
    tiles = -(-n // tm)
    tiles_per_block = -(-tiles // max(1, max_blocks))
    return Plan(tm, nt, resident, tiles_per_block,
                -(-tiles // tiles_per_block), slots, False)


def search_grid(p: Plan, sms: int) -> int:
    """The wide search's grid on a card of ``sms`` SMs: the TF32 form's
    persistent grid takes one block an SM, or one a tile where there are
    fewer tiles; the exact form's blocks each take their own lanes.  The
    grid changes no bits."""
    return p.search_blocks if p.stages == 0 else min(p.search_blocks, sms)


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def rechecks(fn) -> Tuple[int, int]:
    """(exact rechecks in all, most for one point) of the last launch of
    ``fn`` (this wrapper or the fused step's); synchronises."""
    stats = getattr(fn, "recheck_stats", None)
    if stats is None:
        return 0, 0
    total, most = stats.tolist()
    return int(total), int(most)


def _lib() -> ctypes.CDLL:
    return _build.library("distance", _SIGNATURES)


def _check_inputs(x: torch.Tensor, c: torch.Tensor) -> None:
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"need x (n, d) and c (k, d), got {tuple(x.shape)} "
                         f"and {tuple(c.shape)}")
    if c.shape[0] < 1:
        raise ValueError("need at least one centroid")
    if x.device != c.device:
        raise ValueError(f"x on {x.device} but c on {c.device}")
    for name, t in (("x", x), ("c", c)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x: torch.Tensor, c: torch.Tensor, with_dists: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x.shape
    k = c.shape[0]
    if n >= 2**31 or k * d >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: n={n}, k={k}")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return idx, out
    p = plan(n, k, d)
    if assign_bytes(d, p) > MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    lib = _lib()
    smem = lib.assign_smem_bytes(d, p.tm, p.nt, p.slots, int(p.wide),
                                 p.stages, int(p.xres))
    if smem != assign_bytes(d, p):
        raise RuntimeError(f"assign_smem_bytes says {smem} bytes, the plan "
                           f"{assign_bytes(d, p)}: ops.py's layout has "
                           f"drifted from csrc/assign_common.cuh")
    exact = p.wide and p.stages == 0
    cpack = torch.empty(0 if exact else lib.centroid_pack_floats(k, d, p.nt),
                        dtype=torch.float32, device=x.device)
    stats = torch.empty(2, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.assign_clusters(
            x.data_ptr(), c.data_ptr(), n, k, d, p.tm, p.nt, int(p.resident),
            p.tiles_per_block, int(p.wide), p.stages, int(p.xres),
            search_grid(p, sm_count(x.device)), int(with_dists),
            cpack.data_ptr(),
            idx.data_ptr(), out.data_ptr(), stats.data_ptr(), stream)
    _build.check(lib, err, "assign_clusters")
    assign_clusters.launches += 1
    assign_clusters.recheck_stats = stats
    return idx, out


def assign_clusters(x: torch.Tensor, c: torch.Tensor, *,
                    with_dists: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment.

    Args:
      x: (n, d) points, float32 or bfloat16 (computed in float32).
      c: (k, d) centroids, same device.
    Returns:
      (assignment int32 (n,), min squared distance f32 (n,)).  With
      ``with_dists=False`` the second output is the kernel score (distance
      minus ||x||^2) — cheaper, argmin-equivalent.
    """
    _check_inputs(x, c)
    xf, cf = x.float(), c.float()
    if x.is_cuda:
        return _launch(xf, cf, with_dists)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    idx, score = assign_scores_ref(xf, cf)
    if with_dists:
        score = add_point_norms(xf, score)
    return idx, score


assign_clusters.launches = 0
assign_clusters.recheck_stats = None


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Full (n, k) squared-distance matrix (oracle-backed; small inputs)."""
    return pairwise_sq_dists_ref(x, c)
