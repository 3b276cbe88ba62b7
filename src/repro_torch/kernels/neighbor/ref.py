"""Plain PyTorch versions of the DBSCAN neighbourhood kernels.

Same arithmetic as ``csrc/neighbor.cu``: d2 = sum_f (x_i,f - x_j,f)^2 built
feature by feature from element-wise fp32 operations (no fused
multiply-add), so on the card the two agree bit for bit.  Both work in row
chunks: the full (n, n) distance matrix at the main path's n = 65536 would
take 17 GB (the reference's (n, n, d) difference tensor 69 GB).
"""

from __future__ import annotations

import numpy as np
import torch

# Elements of one (rows, n) temporary: 64 MiB of fp32.
_CHUNK_ELEMS = 1 << 24


def eps_squared(eps: float) -> float:
    """eps^2 rounded as the reference rounds it (float32 eps, squared in
    float32)."""
    e = np.float32(eps)
    return float(np.float32(e * e))


def _sq_dists(xr: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """(rows, cols) squared distances, summed in feature order."""
    d2 = torch.zeros((xr.shape[0], xc.shape[0]), dtype=torch.float32,
                     device=xr.device)
    for f in range(xr.shape[1]):
        t = xr[:, f:f + 1] - xc[None, :, f]
        d2 = d2 + t * t
    return d2


def _row_chunks(n_rows: int, n_cols: int):
    rows = max(1, _CHUNK_ELEMS // max(n_cols, 1))
    return range(0, n_rows, rows), rows


def epsilon_degree_ref(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Number of points within eps (inclusive, self counted) per point."""
    x = x.float()
    n = x.shape[0]
    eps2 = eps_squared(eps)
    deg = torch.empty(n, dtype=torch.int32, device=x.device)
    starts, rows = _row_chunks(n, n)
    for r0 in starts:
        d2 = _sq_dists(x[r0:r0 + rows], x)
        deg[r0:r0 + rows] = (d2 <= eps2).sum(1).to(torch.int32)
    return deg


def expand_frontier_ref(x: torch.Tensor, frontier: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """Points within eps of any frontier point (bool (n,)).

    The paper's cluster-expansion kernel: "examine if a data point is
    (directly) reachable from a given core point", batched over the whole
    frontier at once.  Only frontier columns can reach anything, so only
    they are compared.
    """
    x = x.float()
    n = x.shape[0]
    eps2 = eps_squared(eps)
    cols = x[frontier.bool()]
    reach = torch.zeros(n, dtype=torch.bool, device=x.device)
    if cols.shape[0] == 0:
        return reach
    starts, rows = _row_chunks(n, cols.shape[0])
    for r0 in starts:
        d2 = _sq_dists(x[r0:r0 + rows], cols)
        reach[r0:r0 + rows] = (d2 <= eps2).any(1)
    return reach
