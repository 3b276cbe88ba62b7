"""Plain PyTorch versions of the K-Means assignment kernel.

:func:`assign_scores_ref` is the kernel's plain twin: the same score
||c||^2 - 2 x.c, built from the same element-wise fp32 operations in the
same order (feature by feature, no fused multiply-add), so on the card it
agrees with ``csrc/distance.cu`` bit for bit and on the CPU it is what the
wrapper runs.  It works in row chunks: unchunked, the (n, k) temporaries
at the main path's shape would take gigabytes.

:func:`pairwise_sq_dists_ref` is the paper's direct form, an independent
oracle for small inputs.

:func:`fused_masked_assign_update_ref` is the plain twin of the fused
masked Lloyd step (``csrc/fused.cu``): the same assignment, then the masked
per-centroid sums and counts as a one-hot matrix product, chunked by rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Elements of one (rows, k) temporary: 64 MiB of fp32.
_CHUNK_ELEMS = 1 << 24
# The fused step clamps the min score here (the reference's _BIG).
SCORE_CLAMP = 3.4e38


def pairwise_sq_dists_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, (n, d) x (k, d) -> (n, k), direct form."""
    diff = x.float()[:, None, :] - c.float()[None, :, :]
    return (diff * diff).sum(-1)


def centroid_norms_ref(c: torch.Tensor) -> torch.Tensor:
    """||c_j||^2 summed in feature order, (k,) f32."""
    c = c.float()
    norms = torch.zeros(c.shape[0], dtype=torch.float32, device=c.device)
    for f in range(c.shape[1]):
        norms = norms + c[:, f] * c[:, f]
    return norms


def assign_scores_ref(x: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmin int32 (n,), min score f32 (n,)) of ||c||^2 - 2 x.c.

    Ties go to the lowest centroid index (``torch.argmin`` returns the
    first minimum).
    """
    x = x.float()
    c = c.float()
    n, d = x.shape
    k = c.shape[0]
    cnorm = centroid_norms_ref(c)
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    score = torch.empty(n, dtype=torch.float32, device=x.device)
    rows = max(1, _CHUNK_ELEMS // max(k, 1))
    for r0 in range(0, n, rows):
        xr = x[r0:r0 + rows]
        cross = torch.zeros((xr.shape[0], k), dtype=torch.float32,
                            device=x.device)
        for f in range(d):
            cross = cross + xr[:, f:f + 1] * c[None, :, f]
        s = cnorm[None, :] - 2.0 * cross
        arg = torch.argmin(s, dim=1)
        idx[r0:r0 + rows] = arg.to(torch.int32)
        score[r0:r0 + rows] = s.gather(1, arg[:, None])[:, 0]
    return idx, score


def add_point_norms(x: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Squared distance from the score: + ||x||^2, clamped at 0 (the
    decomposition cancels catastrophically when a point sits on a centroid)."""
    xf = x.float()
    return torch.clamp_min(score + (xf * xf).sum(1), 0.0)


def assign_clusters_ref(x: torch.Tensor, c: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (assignment int32 (n,), min squared distance f32 (n,))."""
    idx, score = assign_scores_ref(x, c)
    return idx, add_point_norms(x, score)


def fused_masked_assign_update_ref(x: torch.Tensor, c: torch.Tensor,
                                   mask: torch.Tensor):
    """(assignment int32 (n,), masked sums f32 (k, d), masked counts f32
    (k,), masked inertia f32 ()) — what ``csrc/fused.cu`` computes.

    Masked-out rows are assigned but add nothing; the inertia is
    sum over unmasked rows of max(min(score, 3.4e38) + ||x||^2, 0).
    """
    x = x.float()
    c = c.float()
    n, d = x.shape
    k = c.shape[0]
    w = mask.to(device=x.device, dtype=torch.bool)
    idx, score = assign_scores_ref(x, c)
    d2 = add_point_norms(x, torch.clamp_max(score, SCORE_CLAMP))
    inertia = torch.where(w, d2, torch.zeros_like(d2)).sum()
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    cols = torch.arange(k, dtype=idx.dtype, device=x.device)
    rows = max(1, _CHUNK_ELEMS // max(k, 1))
    for r0 in range(0, n, rows):
        onehot = ((idx[r0:r0 + rows, None] == cols[None, :])
                  & w[r0:r0 + rows, None]).to(torch.float32)
        sums += onehot.T @ x[r0:r0 + rows]
        counts += onehot.sum(0)
    return idx, sums, counts, inertia
