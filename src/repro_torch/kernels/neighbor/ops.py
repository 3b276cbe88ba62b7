"""Public wrappers for the DBSCAN neighbourhood kernels (``csrc/neighbor.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel on the current stream or raises — there is no fallback.
``epsilon_degree.launches`` and ``expand_frontier.launches`` count kernel
launches (plain runs do not count).

eps^2 is passed to the kernel at run time, so a new eps rebuilds nothing.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.neighbor.ref import (
    epsilon_degree_ref,
    eps_squared,
    expand_frontier_ref,
)

# A block's shared memory: 227 KB on Hopper.
_MAX_SMEM = 232448

__all__ = ["epsilon_degree", "expand_frontier", "epsilon_degree_ref",
           "expand_frontier_ref"]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "epsilon_degree": ([_P, _I, _I, _F, _P, _P], ctypes.c_int),
    "expand_frontier": ([_P, _P, _I, _I, _F, _P, _P], ctypes.c_int),
    "neighbor_smem_bytes": ([_I], ctypes.c_size_t),
}


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


def _cuda_lib(x: torch.Tensor) -> ctypes.CDLL:
    n, d = x.shape
    if n * d >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: {tuple(x.shape)}")
    lib = _lib()
    if lib.neighbor_smem_bytes(d) > _MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    return lib


def epsilon_degree(x: torch.Tensor, eps: float) -> torch.Tensor:
    """|N_eps(p)| for every point (self included), int32 (n,)."""
    _check_points(x)
    if not x.is_cuda:
        return epsilon_degree_ref(x, eps)
    n, d = x.shape
    lib = _cuda_lib(x)
    deg = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return deg
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.epsilon_degree(x.data_ptr(), n, d, eps_squared(eps),
                                 deg.data_ptr(), stream)
    _build.check(lib, err, "epsilon_degree")
    epsilon_degree.launches += 1
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
    lib = _cuda_lib(x)
    reach = torch.empty(n, dtype=torch.bool, device=x.device)
    if n == 0:
        return reach
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.expand_frontier(x.data_ptr(), frontier.data_ptr(), n, d,
                                  eps_squared(eps), reach.data_ptr(), stream)
    _build.check(lib, err, "expand_frontier")
    expand_frontier.launches += 1
    return reach


epsilon_degree.launches = 0
expand_frontier.launches = 0
