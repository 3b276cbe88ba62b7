"""DBSCAN, plainly: the brute-force degree and the breadth-first search.

A pair is within eps when d2 = sum over the features, in order, of
(a_f - b_f)^2, each subtraction, square and sum a float32 operation, is
at most eps^2 (float32 eps squared in float32): the exact float32 test the
configuration states.  A point is core when at least min_pts points lie
within eps of it, itself counted.  Clusters are numbered in the order
they are found; the next cluster starts at the lowest-index core point
not yet reached, and grows a whole frontier at a time through the core
points it reaches; a border point goes to the first cluster that reaches
it; 0 is noise.

Pairs are tested in blocks.  The points are sorted by their first
feature, and a block skips only columns whose first feature differs by
more than eps (with a margin): such a pair's first term alone exceeds
eps^2, and float32 sums of non-negative terms never shrink, so the test
would have said no.  The skipped pairs change no answer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.reference.common import rows_per_block, tf32

# Elements of one block's float32 temporaries (128 MiB each).
_ELEMS = 1 << 25


def eps_squared(eps: float) -> float:
    e = np.float32(eps)
    return float(np.float32(e * e))


def _d2(xr: torch.Tensor, xc: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        d2 = torch.zeros((xr.shape[0], xc.shape[0]), dtype=torch.float32,
                         device=xr.device)
        for f in range(xr.shape[1]):
            t = xr[:, f:f + 1] - xc[None, :, f]
            d2 = d2 + t * t
        return d2
    # the control: the norms' expansion with TF32 products
    return ((xr * xr).sum(1, keepdim=True) - 2.0 * (tf32(xr) @ tf32(xc).T)
            + (xc * xc).sum(1))


class _Sorted:
    """The points sorted by their first feature, and how to find the
    columns a block has to test."""

    def __init__(self, x: torch.Tensor, eps: float, precision: str) -> None:
        self.order = torch.argsort(x[:, 0], stable=True)
        self.x = x[self.order].contiguous()
        self.key = self.x[:, 0].contiguous()
        self.eps2 = eps_squared(eps)
        self.precision = precision
        # exact test: a 0.1% margin; the control's rounding needs more
        self.w = float(eps) * 1.001 if precision == "fp32" else float(eps) + 0.25

    def band(self, lo_keys: torch.Tensor, hi_keys: torch.Tensor) -> list:
        lo = torch.searchsorted(self.key, lo_keys - self.w)
        hi = torch.searchsorted(self.key, hi_keys + self.w, right=True)
        return list(zip(lo.tolist(), hi.tolist()))

    def within(self, rows: slice, cols) -> torch.Tensor:
        """(rows, cols) bool: the pairs within eps."""
        xc = self.x[cols]
        return _d2(self.x[rows], xc, self.precision) <= self.eps2


def _degrees(s: _Sorted, rows_block: int = 2048) -> torch.Tensor:
    n = s.x.shape[0]
    deg = torch.zeros(n, dtype=torch.int64, device=s.x.device)
    starts = list(range(0, n, rows_block))
    idx = torch.tensor(starts, device=s.x.device)
    ends = torch.clamp(idx + rows_block, max=n) - 1
    for r0, (lo, hi) in zip(starts, s.band(s.key[idx], s.key[ends])):
        r1 = min(n, r0 + rows_block)
        step = rows_per_block(r1 - r0, _ELEMS)
        for c0 in range(lo, hi, step):
            hit = s.within(slice(r0, r1), slice(c0, min(hi, c0 + step)))
            deg[r0:r1] += hit.sum(1)
    return deg


def _reach(s: _Sorted, front: torch.Tensor, group: int = 1024
           ) -> torch.Tensor:
    """Bool (n,) in sorted order: within eps of a frontier point."""
    n = s.x.shape[0]
    reached = torch.zeros(n, dtype=torch.bool, device=s.x.device)
    fidx = front.nonzero()[:, 0]
    groups = [fidx[g:g + group] for g in range(0, fidx.numel(), group)]
    if not groups:
        return reached
    firsts = torch.stack([g[0] for g in groups])
    lasts = torch.stack([g[-1] for g in groups])
    for cols, (lo, hi) in zip(groups, s.band(s.key[firsts], s.key[lasts])):
        step = rows_per_block(cols.numel(), _ELEMS)
        for r0 in range(lo, hi, step):
            r1 = min(hi, r0 + step)
            reached[r0:r1] |= s.within(slice(r0, r1), cols).any(1)
    return reached


def fit(x: torch.Tensor, eps: float, min_pts: int,
        precision: str = "fp32"
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(labels int32 (n,), 0 noise and clusters 1..C; core bool (n,);
    eps-degree int64 (n,), self counted) of the points in their given
    order."""
    x = x.float().contiguous()
    n = x.shape[0]
    s = _Sorted(x, eps, precision)
    degree = _degrees(s)
    core = degree >= min_pts
    labels = torch.zeros(n, dtype=torch.int32, device=x.device)
    todo = core.clone()
    cid = 0
    while True:
        # the lowest-index (in the caller's order) core point not reached
        cand = torch.where(todo, s.order, torch.full_like(s.order, n))
        first = int(cand.min())
        if first == n:
            break
        cid += 1
        front = torch.zeros(n, dtype=torch.bool, device=x.device)
        front[torch.argmin(cand)] = True
        while bool(front.any()):
            new = _reach(s, front) & (labels == 0)
            labels[new] = cid
            todo &= ~new
            front = new & core
    out_labels = torch.empty_like(labels)
    out_labels[s.order] = labels
    out_core = torch.empty_like(core)
    out_core[s.order] = core
    out_degree = torch.empty_like(degree)
    out_degree[s.order] = degree
    return out_labels, out_core, out_degree
