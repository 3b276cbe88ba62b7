"""Lloyd's K-Means, plainly.

Each step assigns every point to its nearest centroid and moves every
centroid to the mean of its points; a centroid with no points keeps its
place (the paper does not respawn).  The state between steps, the
centroids, is float32, as the configuration states.  Distances are worked
out in float64 from the float32 points and centroids, and the sums in
float64, so the reference's own rounding lies far below the port's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.common import rows_per_block, tf32


def nearest(x: torch.Tensor, c: torch.Tensor, precision: str = "fp64"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index int64 (n,), squared distance float64 (n,)) of each point's
    nearest centroid, in blocks of rows."""
    k = c.shape[0]
    idx = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    best = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    if precision == "fp64":
        cd = c.double()
        cn = (cd * cd).sum(1)
    else:
        ct = tf32(c)
        cn = (c * c).sum(1)
    step = rows_per_block(k)
    for r in range(0, x.shape[0], step):
        xb = x[r:r + step]
        if precision == "fp64":
            xb = xb.double()
            d2 = (xb * xb).sum(1, keepdim=True) - 2.0 * (xb @ cd.T) + cn
        else:
            d2 = ((xb * xb).sum(1, keepdim=True) - 2.0 * (tf32(xb) @ ct.T)
                  + cn)
        v, i = d2.min(1)
        idx[r:r + step] = i
        best[r:r + step] = v.double()
    return idx, best


def sums(x: torch.Tensor, labels: torch.Tensor, k: int,
         precision: str = "fp64") -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-centroid sums (k, d), counts (k,) int64) of the points."""
    dtype = torch.float64 if precision == "fp64" else torch.float32
    out = torch.zeros((k, x.shape[1]), dtype=dtype, device=x.device)
    step = rows_per_block(x.shape[1], 1 << 24)
    for r in range(0, x.shape[0], step):
        xb = x[r:r + step]
        xb = xb.double() if precision == "fp64" else tf32(xb)
        out.index_add_(0, labels[r:r + step], xb)
    return out, torch.bincount(labels, minlength=k)


def update(x: torch.Tensor, labels: torch.Tensor, c_old: torch.Tensor,
           precision: str = "fp64") -> torch.Tensor:
    """The float32 centroids after one update."""
    s, n = sums(x, labels, c_old.shape[0], precision)
    mean = (s / n.clamp(min=1)[:, None].to(s.dtype)).float()
    return torch.where((n > 0)[:, None], mean, c_old)


def lloyd(x: torch.Tensor, c0: torch.Tensor, iterations: int,
          precision: str = "fp64") -> dict:
    """``iterations`` Lloyd steps from ``c0``: the centroids the last step
    assigned against (``last``), its labels and inertia, and the centroids
    after it."""
    c = c0.float().clone()
    last, labels, best = c, None, None
    for _ in range(iterations):
        last = c
        labels, best = nearest(x, c, precision)
        c = update(x, labels, c, precision)
    return {"last": last, "labels": labels, "centroids": c,
            "inertia": float(best.sum())}


def label_mismatch(x: torch.Tensor, c: torch.Tensor,
                   labels: torch.Tensor) -> int:
    """The points whose label is not a nearest centroid of ``c``: its
    squared distance (float64) exceeds the nearest's by more than float32
    rounding of a score allows, 4 (d + 2) 2^-24 (|x|^2 + |c_label|^2 +
    |c_nearest|^2), twice the worst case of a score summed over d
    features in float32; a label outside 0..k-1 always counts."""
    k, d = c.shape
    cd = c.double()
    cn = (cd * cd).sum(1)
    scale = 4.0 * (d + 2) * 2.0 ** -24
    labels = labels.long()
    count = 0
    step = rows_per_block(k)
    for r in range(0, x.shape[0], step):
        xb = x[r:r + step].double()
        xn = (xb * xb).sum(1)
        d2 = xn[:, None] - 2.0 * (xb @ cd.T) + cn
        best, b = d2.min(1)
        lab = labels[r:r + step]
        ok = (lab >= 0) & (lab < k)
        lab = lab.clamp(0, k - 1)
        gap = d2.gather(1, lab[:, None])[:, 0] - best
        window = scale * (xn + cn[lab] + cn[b])
        count += int((~ok | (gap > window)).sum())
    return count


def update_gap(x: torch.Tensor, labels: torch.Tensor,
               centroids: torch.Tensor) -> float:
    """How far the given centroids lie from the means of the points the
    given labels assign them: the largest difference over the features of
    the clusters that have points, over the largest |x|."""
    labels = labels.long()
    s, n = sums(x, labels, centroids.shape[0])
    has = n > 0
    mean = s[has] / n[has][:, None].double()
    gap = (centroids[has].double() - mean).abs().max()
    return float(gap / x.abs().max().double())
