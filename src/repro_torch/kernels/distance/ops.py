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
in shared memory, whether rows are wide enough to stream the products box
by box (``search_tile_wide``), and the grid, all from (n, k, d) alone.
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
# Rows wider than this take the wide search, which is as fast as the
# staged one or faster from 128 features on and slower at 96 and below on
# an H100 (chip_smoke.py's "search forms" rows); whole rows also leave the
# staged search tiles of 64 points or fewer from here on.  Its tiles hold
# _WIDE_TM points, its ring _WIDE_STAGES box steps (kWideTM, kWideStages).
WIDE_D = 96
_WIDE_TM = 64
_WIDE_STAGES = 4
# At most this many blocks: each owns a run of whole tiles.
MAX_BLOCKS = 1024

__all__ = ["assign_bytes", "assign_clusters", "assign_clusters_ref",
           "fused_bytes", "pairwise_sq_dists", "plan", "rechecks"]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "assign_clusters": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P], ctypes.c_int),
    "assign_smem_bytes": ([_I, _I, _I, _I, _I], ctypes.c_size_t),
    "centroid_pack_floats": ([_I, _I, _I], ctypes.c_size_t),
}


class Plan(NamedTuple):
    tm: int               # points per staged tile (a multiple of 16)
    nt: int               # 8-centroid groups per packed chunk: 1, 2, 4, 8
    resident: bool        # every chunk stays in shared memory
    tiles_per_block: int
    blocks: int
    slots: int            # chunks held in shared memory at once
    wide: bool            # d > WIDE_D: the products streamed box by box


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


def assign_bytes(d: int, p: Plan) -> int:
    """Shared memory of an assignment block (assign_smem_bytes): the
    ring and the chunk slots, or for wide rows the ring of box steps (x's
    box and the chunk's hi and lo boxes); alignment slack, mbarriers."""
    if p.wide:
        body = _WIDE_STAGES * (_WIDE_TM + 16 * p.nt) * 128
    else:
        body = 2 * stage_bytes(d, p.tm) + p.slots * chunk_bytes(d, p.nt)
    return _SLACK_BYTES + body + _BARRIER_BYTES


def acc_floats(d: int, tm: int, acc_k: int) -> int:
    """The fused step's sums, counts and row arrays, kept even (fused.cu)."""
    f = acc_k * d + acc_k + 3 * tm
    return f + (f & 1)


def fused_bytes(d: int, p: Plan, acc_k: int) -> int:
    """Shared memory of a fused-step block (fused_smem_bytes)."""
    return assign_bytes(d, p) + 4 * acc_floats(d, p.tm, acc_k)


def plan(n: int, k: int, d: int, max_blocks: int = MAX_BLOCKS) -> Plan:
    """How a search over (n, k, d) is launched; a function of the shape
    alone, so a fused step always sums in the same order.

    Up to WIDE_D features: tiles of up to 128 whole rows in a 2-stage
    ring, chunks of up to 64 centroids resident or staged one at a time.
    Wider rows: tiles of 64 points against chunks of up to 64 centroids,
    streamed a 32-column box at a time (no whole row in shared memory).
    """
    nt = 8
    if d > WIDE_D:
        while nt > 1 and 8 * (nt // 2) >= k:
            nt //= 2
        tm, resident, slots = _WIDE_TM, False, 0
    else:
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
                -(-tiles // tiles_per_block), slots, d > WIDE_D)


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
    smem = lib.assign_smem_bytes(d, p.tm, p.nt, p.slots, int(p.wide))
    if smem != assign_bytes(d, p):
        raise RuntimeError(f"assign_smem_bytes says {smem} bytes, the plan "
                           f"{assign_bytes(d, p)}: ops.py's layout has "
                           f"drifted from csrc/assign_common.cuh")
    cpack = torch.empty(lib.centroid_pack_floats(k, d, p.nt),
                        dtype=torch.float32, device=x.device)
    stats = torch.empty(2, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.assign_clusters(
            x.data_ptr(), c.data_ptr(), n, k, d, p.tm, p.nt, int(p.resident),
            p.tiles_per_block, int(p.wide), int(with_dists),
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
