"""Public wrappers for the DBSCAN neighbourhood kernels (``csrc/neighbor.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel on the current stream or raises — there is no fallback.
``epsilon_degree.launches`` and ``expand_frontier.launches`` count kernel
launches (plain runs do not count); ``recheck_stats`` holds the last
launch's exact rechecks and pairs scored (:func:`rechecks` reads them).

The cross entries :func:`epsilon_degree_cross` and
:func:`expand_frontier_cross` take rows of one point set against columns
of another (a shard of the distributed lane's ring against the column
shard it holds), with launch counters and recheck stats of their own.

eps^2 is passed to the kernel at run time, so a new eps rebuilds nothing.

The library owns the launch's layout: how a launch is cut (:func:`plan`
reads ``neighbor_plan``), the shared memory a block needs and the scratch
a call needs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.neighbor.ref import (
    epsilon_degree_ref,
    eps_squared,
    epsilon_degree_cross_ref,
    expand_frontier_cross_ref,
    expand_frontier_ref,
    pack_ksteps,
)

# A block's shared memory: 227 KB on Hopper.
MAX_SMEM = 232448

__all__ = ["epsilon_degree", "expand_frontier", "epsilon_degree_cross",
           "expand_frontier_cross", "epsilon_degree_ref",
           "expand_frontier_ref", "epsilon_degree_cross_ref",
           "expand_frontier_cross_ref", "plan", "rechecks"]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "epsilon_degree": ([_P, _I, _I, _F, _P, _P, _P, _P], ctypes.c_int),
    "expand_frontier": ([_P, _P, _I, _I, _F, _P, _P, _P, _P], ctypes.c_int),
    "epsilon_degree_cross": ([_P, _I, _P, _I, _I, _F, _P, _P, _P, _P],
                             ctypes.c_int),
    "expand_frontier_cross": ([_P, _I, _P, _P, _I, _I, _F, _P, _P, _P, _P],
                              ctypes.c_int),
    "neighbor_smem_bytes": ([_I], ctypes.c_size_t),
    "neighbor_plan": ([_I, _I, _I, _I, _I, _P], None),
    "neighbor_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_size_t),
}


class Plan(NamedTuple):
    groups: int       # 64-row groups a block holds
    row_groups: int   # groups of 64 x groups rows
    slices: int       # blocks along the columns (of a pair of row groups)
    slice_len: int    # columns (points) of one slice (the rectangle)
    triangle: bool    # the degree over one point set at d <= 9
    blocks: int


def plan(n: int, d: int, expand: bool = False,
         cols: Optional[int] = None) -> Plan:
    """How the library cuts a launch over n points of d features, or with
    ``cols`` a cross launch of n rows against that many columns
    (``csrc/neighbor.cu``: ``plan_for``); builds the library."""
    out = (ctypes.c_int * 6)()
    cross = cols is not None
    _lib().neighbor_plan(n, cols if cross else n, d, int(expand), int(cross),
                         out)
    groups, row_groups, slices, slice_len, triangle, blocks = out
    return Plan(groups, row_groups, slices, slice_len, bool(triangle),
                blocks)


def rechecks(fn) -> Tuple[int, int]:
    """(exact rechecks, pairs scored) of the last launch of ``fn``;
    synchronises."""
    stats = getattr(fn, "recheck_stats", None)
    if stats is None:
        return 0, 0
    total, pairs = stats.tolist()
    return int(total), int(pairs)


def _lib() -> ctypes.CDLL:
    return _build.library("neighbor", _SIGNATURES)


def _check_points(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"need x (n, d), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


@functools.lru_cache(maxsize=256)
def _scratch_floats(n: int, d: int, expand: bool,
                    cols: Optional[int] = None) -> int:
    """Floats of one call's scratch (``cols``: a cross call), the shape
    checked against the library's limits once."""
    for m in (n, n if cols is None else cols):
        if (m + 1) * 8 * pack_ksteps(d) >= 2**30 or m * d >= 2**31:
            raise ValueError(f"shape too large for int32 indexing: "
                             f"({m}, {d})")
    lib = _lib()
    if lib.neighbor_smem_bytes(d) > MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    cross = cols is not None
    return lib.neighbor_scratch_floats(n, cols if cross else n, d,
                                       int(expand), int(cross))


def _launch(fn, x: torch.Tensor, eps: float, out: torch.Tensor,
            frontier: Optional[torch.Tensor] = None,
            cols: Optional[torch.Tensor] = None) -> None:
    """One launch of ``fn``: over x, or (``cols``) x's rows against the
    columns ``cols``; ``frontier`` flags the columns for the expansion."""
    n, d = x.shape
    expand = frontier is not None
    nc = None if cols is None else cols.shape[0]
    scratch = torch.empty(_scratch_floats(n, d, expand, nc),
                          dtype=torch.float32, device=x.device)
    stats = torch.empty(2, dtype=torch.int64, device=x.device)
    lib = _lib()
    eps2 = eps_squared(eps)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (scratch.data_ptr(), out.data_ptr(), stats.data_ptr(), stream)
        if cols is not None and expand:
            err = lib.expand_frontier_cross(x.data_ptr(), n, cols.data_ptr(),
                                            frontier.data_ptr(), nc, d, eps2,
                                            *ptrs)
        elif cols is not None:
            err = lib.epsilon_degree_cross(x.data_ptr(), n, cols.data_ptr(),
                                           nc, d, eps2, *ptrs)
        elif expand:
            err = lib.expand_frontier(x.data_ptr(), frontier.data_ptr(), n, d,
                                      eps2, *ptrs)
        else:
            err = lib.epsilon_degree(x.data_ptr(), n, d, eps2, *ptrs)
    _build.check(lib, err, fn.__name__)
    fn.launches += 1
    fn.recheck_stats = stats


def epsilon_degree(x: torch.Tensor, eps: float) -> torch.Tensor:
    """|N_eps(p)| for every point (self included), int32 (n,)."""
    _check_points(x)
    if not x.is_cuda:
        return epsilon_degree_ref(x, eps)
    deg = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.shape[0]:
        _launch(epsilon_degree, x, eps, deg)
    return deg


def expand_frontier(x: torch.Tensor, frontier: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Bool (n,): within eps of some frontier point (the expansion kernel)."""
    _check_points(x)
    n, d = x.shape
    if frontier.shape != (n,) or frontier.dtype != torch.bool:
        raise ValueError(f"frontier must be bool ({n},), got "
                         f"{frontier.dtype} {tuple(frontier.shape)}")
    if frontier.device != x.device or not frontier.is_contiguous():
        raise ValueError("frontier must be contiguous on x's device")
    if not x.is_cuda:
        return expand_frontier_ref(x, frontier, eps)
    reach = torch.empty(n, dtype=torch.bool, device=x.device)
    if n:
        _launch(expand_frontier, x, eps, reach, frontier)
    return reach


def _check_cross(rows: torch.Tensor, cols: torch.Tensor) -> None:
    _check_points(rows)
    _check_points(cols)
    if cols.shape[1] != rows.shape[1] or cols.device != rows.device:
        raise ValueError(f"cols must have rows' width and device: rows "
                         f"{tuple(rows.shape)} on {rows.device}, cols "
                         f"{tuple(cols.shape)} on {cols.device}")


def epsilon_degree_cross(rows: torch.Tensor, cols: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """int32 (n_rows,): the columns within eps of each row.  Summed over
    the column shards of x, the rows' :func:`epsilon_degree`."""
    _check_cross(rows, cols)
    if not rows.is_cuda:
        return epsilon_degree_cross_ref(rows, cols, eps)
    if not (rows.shape[0] and cols.shape[0]):
        return torch.zeros(rows.shape[0], dtype=torch.int32,
                           device=rows.device)
    deg = torch.empty(rows.shape[0], dtype=torch.int32, device=rows.device)
    _launch(epsilon_degree_cross, rows, eps, deg, cols=cols)
    return deg


def expand_frontier_cross(rows: torch.Tensor, cols: torch.Tensor,
                          front_cols: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """Bool (n_rows,): within eps of a column flagged in ``front_cols``.
    OR-ed over the column shards of x, the rows' :func:`expand_frontier`."""
    _check_cross(rows, cols)
    nc = cols.shape[0]
    if front_cols.shape != (nc,) or front_cols.dtype != torch.bool:
        raise ValueError(f"front_cols must be bool ({nc},), got "
                         f"{front_cols.dtype} {tuple(front_cols.shape)}")
    if front_cols.device != cols.device or not front_cols.is_contiguous():
        raise ValueError("front_cols must be contiguous on cols' device")
    if not rows.is_cuda:
        return expand_frontier_cross_ref(rows, cols, front_cols, eps)
    if not (rows.shape[0] and nc):
        return torch.zeros(rows.shape[0], dtype=torch.bool,
                           device=rows.device)
    reach = torch.empty(rows.shape[0], dtype=torch.bool, device=rows.device)
    _launch(expand_frontier_cross, rows, eps, reach, front_cols, cols=cols)
    return reach


for _fn in (epsilon_degree, expand_frontier, epsilon_degree_cross,
            expand_frontier_cross):
    _fn.launches = 0
    _fn.recheck_stats = None
