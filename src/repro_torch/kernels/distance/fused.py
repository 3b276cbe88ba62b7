"""Fused masked K-Means step: one kernel call per Lloyd iteration.

The unfused step (``core/kmeans.py:masked_kmeans_step``) runs the assignment
kernel and then a one-hot matrix product over ``x`` for the centroid
update.  ``csrc/fused.cu`` computes the assignment *and* the masked
per-centroid sums, counts and inertia in one kernel pass over ``x`` plus a
small deterministic reduction of per-block partials (no float atomics, so
the sums are bitwise identical from run to run).  Its search is the
assignment kernel's (``csrc/assign_common.cuh``), launched by the same
:func:`~repro_torch.kernels.distance.ops.plan`.

A CPU tensor takes the plain version (:func:`fused_masked_assign_update_ref`
in :mod:`.ref`); a CUDA tensor launches the kernel on the current stream or
raises — there is no fallback.  ``fused_masked_assign_update.launches``
counts kernel launches (plain runs do not count);
``fused_masked_assign_update.recheck_stats`` holds the last launch's count
of exact rechecks (``ops.rechecks`` reads it).

The two passes also run apart, for the distributed lane's shards
(``core/distributed.py``): :func:`fused_masked_partials` is pass 1 over
one shard's rows with the whole item's blocks (:func:`block_rows`), and
:func:`reduce_partials` is pass 2 over every shard's partials in block
order.  Shards cut at multiples of ``block_rows`` write the whole launch's
partials, block for block, so the reduced sums are the one launch's bits
whatever the number of shards.  A pass-1 launch adds one to
``fused_masked_assign_update.launches`` (it is the fused kernel);
``reduce_partials.launches`` counts pass 2 alone.

On the meta device (the dry-run) the two passes take their shape ops
(:mod:`repro_torch.kernels.shape_ops`): empty outputs, no launch counted,
and the work counted as FLOPs: 2 n k d for the scores and n d for the
sums (pass 1), an add per partial float (pass 2).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, shape_ops
from repro_torch.kernels.distance import ops
from repro_torch.kernels.distance.ref import (
    fused_masked_assign_update_ref,
    fused_masked_partials_ref,
    reduce_partials_ref,
)

# At most this many partial floats in all.
_MAX_PARTIAL_FLOATS = 1 << 24
# fp32 counts are exact up to 2^24 rows.
MAX_ROWS = 1 << 24

__all__ = ["block_rows", "fused_masked_assign_update",
           "fused_masked_assign_update_ref", "fused_masked_partials",
           "fused_masked_partials_ref", "reduce_partials",
           "reduce_partials_ref"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_masked_assign_update": (
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
         _P, _P], ctypes.c_int),
    "fused_masked_partials": (
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
         _P], ctypes.c_int),
    "fused_reduce_partials": ([_P, _I, _I, _P, _P], ctypes.c_int),
    "fused_smem_bytes": ([_I, _I, _I, _I, _I, _I], ctypes.c_size_t),
    "centroid_pack_floats": ([_I, _I, _I], ctypes.c_size_t),
}


def _lib() -> ctypes.CDLL:
    return _build.library("fused", _SIGNATURES)


def build() -> None:
    """Build and load ``csrc/fused.cu`` now (it is built at first use
    otherwise); raises :class:`~repro_torch.kernels._build.KernelBuildError`
    if ``nvcc`` is missing or refuses it."""
    _lib()


def _check_inputs(x: torch.Tensor, c: torch.Tensor,
                  mask: torch.Tensor) -> None:
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"need x (n, d) and c (k, d), got {tuple(x.shape)} "
                         f"and {tuple(c.shape)}")
    if c.shape[0] < 1:
        raise ValueError("need at least one centroid")
    if mask.shape != (x.shape[0],) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool ({x.shape[0]},), got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for name, t in (("x", x), ("c", c), ("mask", mask)):
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"n={x.shape[0]} rows: fp32 counts are exact only "
                         f"up to {MAX_ROWS}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")


def _plan(n: int, k: int, d: int) -> Tuple[ops.Plan, int]:
    """The search's plan (blocks capped so the partials stay a few MB and
    pass 2 short) and acc_k, the centroids whose sums fit the shared
    memory left."""
    stride = k * d + k + 1
    p = ops.plan(n, k, d, max_blocks=max(1, min(
        ops.MAX_BLOCKS, _MAX_PARTIAL_FLOATS // stride)))
    left = ops.MAX_SMEM - ops.fused_bytes(d, p, 0)
    acc_k = max(1, min(k, left // (4 * (d + 1))))
    while acc_k > 1 and ops.fused_bytes(d, p, acc_k) > ops.MAX_SMEM:
        acc_k -= 1
    return p, acc_k


def block_rows(n: int, k: int, d: int) -> int:
    """Rows of one pass-1 block of the fused step over n rows
    (tiles_per_block x tm): the cuts that leave every block's partial
    sums as they are."""
    p, _ = _plan(n, k, d)
    return p.tiles_per_block * p.tm


def launch_shape(n: int, k: int, d: int) -> Tuple[int, int, int]:
    """(tiles_per_block, blocks, acc_k) of pass 1 for this problem.

    A function of the shape alone, so the same inputs always reduce in the
    same order.  Tiles hold ``ops.plan(n, k, d).tm`` points; ``acc_k``
    centroids' sums fit the shared memory at a time.
    """
    p, acc_k = _plan(n, k, d)
    return p.tiles_per_block, p.blocks, acc_k


def _launch(x: torch.Tensor, c: torch.Tensor, mask: torch.Tensor,
            rows_per_block: Optional[int] = None):
    """Pass 1 over x, then pass 2 (``rows_per_block`` None: the plan's
    own blocks), or pass 1 alone with blocks of ``rows_per_block`` rows;
    returns (idx, out) or (idx, part (blocks, stride))."""
    n, d = x.shape
    k = c.shape[0]
    stride = k * d + k + 1
    if n * d >= 2**31 or stride >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: n={n}, k={k}, "
                         f"d={d}")
    p, acc_k = _plan(n, k, d)
    if rows_per_block is not None:
        if rows_per_block < 1 or rows_per_block % p.tm:
            raise ValueError(f"rows_per_block={rows_per_block} is not a "
                             f"whole number of {p.tm}-row tiles")
        tpb = rows_per_block // p.tm
        tiles = -(-n // p.tm)
        p = p._replace(tiles_per_block=tpb, blocks=-(-tiles // tpb))
    if ops.fused_bytes(d, p, acc_k) > ops.MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    lib = _lib()
    smem = lib.fused_smem_bytes(d, p.tm, p.nt, p.slots, int(p.wide), acc_k)
    if smem != ops.fused_bytes(d, p, acc_k):
        raise RuntimeError(f"fused_smem_bytes says {smem} bytes, the plan "
                           f"{ops.fused_bytes(d, p, acc_k)}: ops.py's layout "
                           f"has drifted from csrc/fused.cu")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    cpack = torch.empty(lib.centroid_pack_floats(k, d, p.nt),
                        dtype=torch.float32, device=x.device)
    part = torch.empty((p.blocks, stride), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty(2, dtype=torch.int64, device=x.device)
    args = (x.data_ptr(), c.data_ptr(), mask.data_ptr(), n, k, d, p.tm, p.nt,
            int(p.resident), p.tiles_per_block, int(p.wide), acc_k,
            cpack.data_ptr(), idx.data_ptr(), part.data_ptr())
    out = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if rows_per_block is None:
            out = torch.empty(stride, dtype=torch.float32, device=x.device)
            err = lib.fused_masked_assign_update(
                *args, out.data_ptr(), stats.data_ptr(), stream)
        else:
            err = lib.fused_masked_partials(*args, stats.data_ptr(), stream)
    _build.check(lib, err, "fused_masked_assign_update")
    fused_masked_assign_update.launches += 1
    fused_masked_assign_update.recheck_stats = stats
    return idx, (part if out is None else out)


def _partials_meta(x, c, mask, rows_per_block):
    n, d = x.shape
    k = c.shape[0]
    return (x.new_empty((n,), dtype=torch.int32),
            x.new_empty((-(-n // rows_per_block), k * d + k + 1)))


_partials_shape = shape_ops.define(
    "fused_partials_shape",
    "(Tensor x, Tensor c, Tensor mask, int rows_per_block) "
    "-> (Tensor, Tensor)",
    _partials_meta,
    lambda x, c, mask, rows: 2 * x[0] * c[0] * x[1] + x[0] * x[1])
_reduce_shape = shape_ops.define(
    "reduce_partials_shape", "(Tensor part, int k, int d) -> Tensor",
    lambda part, k, d: part.new_empty((part.shape[1],)),
    lambda part, k, d: part[0] * part[1])


def _split(out: torch.Tensor, k: int, d: int):
    return out[:k * d].view(k, d), out[k * d:k * d + k], out[k * d + k]


def fused_masked_assign_update(
        x: torch.Tensor, c: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused assignment + masked accumulation.

    Args:
      x: (n, d) float32 points.
      c: (k, d) float32 centroids, same device.
      mask: (n,) bool — False rows are assigned but carry no weight.
    Returns:
      (assignment int32 (n,), masked sums f32 (k, d), masked counts f32
      (k,), masked inertia f32 ()).
    """
    _check_inputs(x, c, mask)
    if not x.is_cuda:
        return fused_masked_assign_update_ref(x, c, mask)
    n, d = x.shape
    k = c.shape[0]
    if n == 0:
        zeros = torch.zeros(k * d + k + 1, dtype=torch.float32,
                            device=x.device)
        return (torch.empty(0, dtype=torch.int32, device=x.device),
                *_split(zeros, k, d))
    idx, out = _launch(x, c, mask)
    return (idx, *_split(out, k, d))


def fused_masked_partials(
        x: torch.Tensor, c: torch.Tensor, mask: torch.Tensor,
        rows_per_block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of :func:`fused_masked_assign_update` over x's rows in blocks
    of ``rows_per_block`` rows (a multiple of the plan's tile, from
    :func:`block_rows` of the whole item): (assignment int32 (n,), partials
    f32 (blocks, k*d + k + 1), each [sums | counts | inertia] of a block's
    unmasked rows)."""
    _check_inputs(x, c, mask)
    if x.device.type == "meta":
        return _partials_shape(x, c, mask, rows_per_block)
    if not x.is_cuda:
        return fused_masked_partials_ref(x, c, mask, rows_per_block)
    n, d = x.shape
    k = c.shape[0]
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=x.device),
                torch.empty((0, k * d + k + 1), dtype=torch.float32,
                            device=x.device))
    return _launch(x, c, mask, rows_per_block)


def reduce_partials(part: torch.Tensor, k: int, d: int):
    """Pass 2: the sums (k, d), counts (k,) and inertia () of the partials
    (blocks, k*d + k + 1), added in :func:`fused_masked_assign_update`'s
    order (eight runs of blocks in order, then the eight in order)."""
    stride = k * d + k + 1
    if part.dim() != 2 or part.shape[1] != stride or part.shape[0] < 1:
        raise ValueError(f"need partials (blocks >= 1, {stride}), got "
                         f"{tuple(part.shape)}")
    if part.dtype != torch.float32 or not part.is_contiguous():
        raise ValueError("partials must be contiguous float32")
    if part.device.type == "meta":
        return _split(_reduce_shape(part, k, d), k, d)
    if not part.is_cuda:
        return reduce_partials_ref(part, k, d)
    out = torch.empty(stride, dtype=torch.float32, device=part.device)
    lib = _lib()
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        err = lib.fused_reduce_partials(part.data_ptr(), part.shape[0],
                                        stride, out.data_ptr(), stream)
    _build.check(lib, err, "reduce_partials")
    reduce_partials.launches += 1
    return _split(out, k, d)


fused_masked_assign_update.launches = 0
fused_masked_assign_update.recheck_stats = None
reduce_partials.launches = 0
