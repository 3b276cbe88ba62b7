"""Public wrapper around the K-Means assignment kernel (``csrc/distance.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel on the current stream or raises — there is no fallback.
``assign_clusters.launches`` counts kernel launches (plain runs do not
count), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance.ref import (
    add_point_norms,
    assign_clusters_ref,
    assign_scores_ref,
    pairwise_sq_dists_ref,
)

# A block's shared memory: 227 KB on Hopper.
_MAX_SMEM = 232448

__all__ = ["assign_clusters", "assign_clusters_ref", "pairwise_sq_dists"]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "assign_clusters": ([_P, _P, _I, _I, _I, _P, _P, _P], ctypes.c_int),
    "assign_smem_bytes": ([_I], ctypes.c_size_t),
}


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


def _launch(x: torch.Tensor, c: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x.shape
    k = c.shape[0]
    if n >= 2**31 or k * d >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: n={n}, k={k}")
    lib = _lib()
    if lib.assign_smem_bytes(d) > _MAX_SMEM:
        raise ValueError(f"d={d} needs more shared memory than a block has")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    score = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return idx, score
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.assign_clusters(x.data_ptr(), c.data_ptr(), n, k, d,
                                  idx.data_ptr(), score.data_ptr(), stream)
    _build.check(lib, err, "assign_clusters")
    assign_clusters.launches += 1
    return idx, score


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
        idx, score = _launch(xf, cf)
    elif x.device.type == "cpu":
        idx, score = assign_scores_ref(xf, cf)
    else:
        raise ValueError(f"unsupported device {x.device}")
    if with_dists:
        score = add_point_norms(xf, score)
    return idx, score


assign_clusters.launches = 0


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Full (n, k) squared-distance matrix (oracle-backed; small inputs)."""
    return pairwise_sq_dists_ref(x, c)
