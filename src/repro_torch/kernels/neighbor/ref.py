"""Plain PyTorch versions of the DBSCAN neighbourhood kernels.

Same arithmetic as ``csrc/neighbor.cu``'s exact recheck: d2 = sum_f
(x_i,f - x_j,f)^2 built feature by feature from element-wise fp32
operations (no fused multiply-add), so on the card the two agree bit for
bit.  Both work in row chunks: the full (n, n) distance matrix at the main
path's n = 65536 would take 17 GB (the reference's (n, n, d) difference
tensor 69 GB).

:func:`packed_rows`, :func:`packed_cols`, :func:`candidate_scores`,
:func:`pair_window` and :func:`classify` are a plain model of how the
kernels decide a pair: a candidate d2 - eps^2 from TF32 products on the
tensor cores (the depth packed: coordinates, norms and eps^2 in one
product), a window that certainly holds the exact value, and an exact
recheck of the pairs inside it.  Only the tests use them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.distance.ref import _mma_step, tf32_round

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
    return epsilon_degree_cross_ref(x, x, eps)


def expand_frontier_ref(x: torch.Tensor, frontier: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """Points within eps of any frontier point (bool (n,)).

    The paper's cluster-expansion kernel: "examine if a data point is
    (directly) reachable from a given core point", batched over the whole
    frontier at once.  Only frontier columns can reach anything, so only
    they are compared.
    """
    return expand_frontier_cross_ref(x, x, frontier, eps)


def epsilon_degree_cross_ref(rows: torch.Tensor, cols: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """Number of columns within eps (inclusive) of each row, int32
    (n_rows,): the cross entry's plain version.  Summed over the column
    shards of x, :func:`epsilon_degree_ref` of the rows."""
    rows, cols = rows.float(), cols.float()
    eps2 = eps_squared(eps)
    deg = torch.zeros(rows.shape[0], dtype=torch.int32, device=rows.device)
    if cols.shape[0] == 0:
        return deg
    starts, chunk = _row_chunks(rows.shape[0], cols.shape[0])
    for r0 in starts:
        d2 = _sq_dists(rows[r0:r0 + chunk], cols)
        deg[r0:r0 + chunk] = (d2 <= eps2).sum(1).to(torch.int32)
    return deg


def expand_frontier_cross_ref(rows: torch.Tensor, cols: torch.Tensor,
                              front_cols: torch.Tensor,
                              eps: float) -> torch.Tensor:
    """Rows within eps of a column flagged in ``front_cols`` (bool
    (n_rows,)): the cross entry's plain version.  OR-ed over the column
    shards of x, :func:`expand_frontier_ref` of the rows."""
    return epsilon_degree_cross_ref(
        rows, cols.float()[front_cols.bool()], eps) > 0


# --- a plain model of the kernels' candidate and window (tests only) -------

# The window (csrc/neighbor.cu derives it), one per row and 64-column tile:
# E = kappa(d) Q + 2^-100 (1 + r_i + R_J), Q = (r_i + R_J)^2 + eps^2, r the
# norms, R_J the largest over the tile's columns; where Q is not below
# 2^100 (or not finite) E = inf: every pair of the row and tile rechecks.
WINDOW_ABS = 2.0 ** -100
WINDOW_GUARD = 2.0 ** 100
TILE = 64


def pack_ksteps(d: int) -> int:
    """k-steps of 8 of one packed point: 3 d + 4 terms."""
    return -(-(3 * d + 4) // 8)


def window_kappa(d: int) -> float:
    """kappa(d) = (3 d + 27 + 18 ks) 2^-22."""
    return (3 * d + 27 + 18 * pack_ksteps(d)) * 2.0 ** -22


def _split(v: torch.Tensor):
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def _norms(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(x.shape[0], dtype=torch.float32)
    for f in range(x.shape[1]):
        out = out + x[:, f] * x[:, f]
    return out


def _pad(cols, d: int) -> torch.Tensor:
    t = torch.cat(cols, dim=1).double()
    return torch.nn.functional.pad(t, (0, 8 * pack_ksteps(d) - t.shape[1]))


def packed_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, 8 ks) row vectors [xh, xh, xl | nh, nl, 1, 1, 0 ...] (float64
    holding TF32 values), as the kernels' pack writes them."""
    x = x.float()
    xh, xl = _split(x)
    nh, nl = _split(_norms(x))
    one = torch.ones((x.shape[0], 1))
    return _pad([xh, xh, xl, nh[:, None], nl[:, None], one, one], x.shape[1])


def packed_cols(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(n, 8 ks) column vectors [-2 xh, -2 xl, -2 xh | 1, 1, mh, ml, 0 ...],
    m = fl(||x||^2 - eps^2)."""
    x = x.float()
    xh, xl = _split(x)
    mh, ml = _split(_norms(x) - torch.tensor(eps_squared(eps)))
    one = torch.ones((x.shape[0], 1))
    return _pad([-2 * xh, -2 * xl, -2 * xh, one, one, mh[:, None],
                 ml[:, None]], x.shape[1])


def candidate_scores(xr: torch.Tensor, xc: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """(rows, cols) candidates c~ ~ d2 - eps^2 as the kernels' tensor cores
    form them: k-step by k-step, 8 exact products each, through the
    truncating accumulation of ``distance.ref._mma_step``."""
    a, b = packed_rows(xr), packed_cols(xc, eps)
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64)
    for k in range(0, a.shape[1], 8):
        acc = _mma_step(acc, a[:, None, k:k + 8] * b[None, :, k:k + 8])
    return acc


def pair_window(xr: torch.Tensor, xc: torch.Tensor,
                eps: float) -> torch.Tensor:
    """(rows, cols) E with |c~ - (d2 - eps^2)| <= E for the exact d2 of the
    plain version, one per row and tile of 64 columns; +inf where the
    guard sends the pairs to the exact recheck."""
    rr = _norms(xr.float()).double().sqrt()
    rc = _norms(xc.float()).double().sqrt()
    pad = -rc.shape[0] % TILE
    tiles = torch.nn.functional.pad(rc, (0, pad)).view(-1, TILE).amax(1)
    rj = tiles.repeat_interleave(TILE)[: rc.shape[0]]
    s = rr[:, None] + rj[None, :]
    q = s * s + eps_squared(eps)
    e = window_kappa(xr.shape[1]) * q + WINDOW_ABS * (1.0 + s)
    return torch.where(q < WINDOW_GUARD, e, torch.full_like(e, float("inf")))


def classify(xr: torch.Tensor, xc: torch.Tensor, eps: float,
             approx: torch.Tensor, window: torch.Tensor):
    """(counted, rechecked): bool (rows, cols), a pair counted as the
    kernels count it (c~ < -E for certain, or inside the window and the
    exact d2 within eps), and the pairs the window sends to the recheck
    (|c~| <= E, NaN included)."""
    within = _sq_dists(xr.float(), xc.float()) <= eps_squared(eps)
    recheck = ~(approx.abs() > window)
    return (approx < -window) | (recheck & within), recheck
