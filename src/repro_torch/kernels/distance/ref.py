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

:func:`lloyd_sums_ref` is the plain twin of the one-job step's narrow-row
sums (``csrc/fused.cu``, ``lloyd_sums_kernel`` and pass 2): each thread's
rows in order, a warp's xor tree, a block's warps in order, the blocks'
partials as the fused step reduces them.

:func:`tf32_round`, :func:`tf32x3_scores`, :func:`score_window` and
:func:`recheck_argmin` are a plain model of how the kernels find the argmin:
candidate scores from three TF32 products on the tensor cores, a window
that certainly holds the exact score, and an exact recheck of the few
candidates the window leaves.  Only the tests use them.
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
    """||c_j||^2 of every row, summed in feature order, (k,) f32 (the
    kernels sum point norms the same way)."""
    c = c.float()
    norms = torch.zeros(c.shape[0], dtype=torch.float32, device=c.device)
    for f in range(c.shape[1]):
        norms = norms + c[:, f] * c[:, f]
    return norms


def _exact_scores(xr: torch.Tensor, c: torch.Tensor,
                  cnorm: torch.Tensor) -> torch.Tensor:
    """(rows, k) scores ||c||^2 - 2 x.c, the products summed in feature
    order with no fused multiply-add (the kernels' exact arithmetic)."""
    cross = torch.zeros((xr.shape[0], c.shape[0]), dtype=torch.float32,
                        device=xr.device)
    for f in range(xr.shape[1]):
        cross = cross + xr[:, f:f + 1] * c[None, :, f]
    return cnorm[None, :] - 2.0 * cross


def assign_scores_ref(x: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmin int32 (n,), min score f32 (n,)) of ||c||^2 - 2 x.c.

    Ties go to the lowest centroid index (``torch.argmin`` returns the
    first minimum; a NaN score counts as the minimum).
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
        s = _exact_scores(x[r0:r0 + rows], c, cnorm)
        arg = torch.argmin(s, dim=1)
        idx[r0:r0 + rows] = arg.to(torch.int32)
        score[r0:r0 + rows] = s.gather(1, arg[:, None])[:, 0]
    return idx, score


def add_point_norms(x: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Squared distance from the score: + ||x||^2, clamped at 0 (the
    decomposition cancels catastrophically when a point sits on a centroid)."""
    return torch.clamp_min(score + centroid_norms_ref(x), 0.0)


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


# The fused step's pass 2 adds the blocks' partials in this many runs of
# blocks, each in order, then the runs in order (csrc/fused.cu).
REDUCE_RUNS = 8


def fused_masked_partials_ref(x: torch.Tensor, c: torch.Tensor,
                              mask: torch.Tensor, rows_per_block: int):
    """(assignment int32 (n,), partials f32 (blocks, k*d + k + 1)): each
    block of ``rows_per_block`` rows' [sums | counts | inertia], as
    :func:`fused_masked_assign_update_ref` computes them for those rows."""
    n, d = x.shape
    k = c.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    rows = []
    for r0 in range(0, n, rows_per_block):
        r1 = min(n, r0 + rows_per_block)
        idx[r0:r1], sums, counts, inertia = fused_masked_assign_update_ref(
            x[r0:r1], c, mask[r0:r1])
        rows.append(torch.cat([sums.reshape(-1), counts, inertia[None]]))
    part = (torch.stack(rows) if rows else
            torch.empty((0, k * d + k + 1), dtype=torch.float32,
                        device=x.device))
    return idx, part


def reduce_partials_ref(part: torch.Tensor, k: int, d: int):
    """(sums (k, d), counts (k,), inertia ()) of the partials, added in
    the fused kernel's pass-2 order, every addition rounded to fp32."""
    blocks = part.shape[0]
    out = None
    for w in range(REDUCE_RUNS):
        run = torch.zeros(part.shape[1], dtype=torch.float32,
                          device=part.device)
        for b in range(w * blocks // REDUCE_RUNS,
                       (w + 1) * blocks // REDUCE_RUNS):
            run = run + part[b]
        out = run if out is None else out + run
    return out[:k * d].view(k, d), out[k * d:k * d + k], out[k * d + k]


# The narrow-row sums' form (csrc/fused.cu, read back by its lloyd_form
# entry before the first launch): threads a block, and the most centroids
# and features a thread keeps in registers.
LLOYD_THREADS = 256
LLOYD_MAX_K = 8
LLOYD_MAX_D = 4
_LANES = 32


def lloyd_partials_ref(x: torch.Tensor, idx: torch.Tensor, k: int,
                       blocks: int) -> torch.Tensor:
    """The narrow-row sums' pass 1 (``lloyd_sums_kernel``): partials f32
    (blocks, k*d + k + 1), each [sums | counts | 0] of a block, added in
    the kernel's order.

    Thread t of the T = blocks x LLOYD_THREADS takes rows t, t + T, ... in
    order, adding a row to its label's sums; a warp's 32 threads then add
    by an xor tree (lane l takes l + (l ^ o) for o = 16, 8, 4, 2, 1), and
    the block adds its warps in order.  Counts are integers to the end.
    Every addition is rounded to fp32.
    """
    x = x.float()
    n, d = x.shape
    threads = blocks * LLOYD_THREADS
    acc = torch.zeros((threads, k, d), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((threads, k), dtype=torch.int64, device=x.device)
    cols = torch.arange(k, device=x.device)
    for r0 in range(0, n, threads):
        m = min(threads, n - r0)
        hit = idx[r0:r0 + m, None].long() == cols[None, :]
        a = acc[:m]
        acc[:m] = torch.where(hit[:, :, None], a + x[r0:r0 + m, None, :], a)
        cnt[:m] += hit
    acc = acc.view(blocks, LLOYD_THREADS // _LANES, _LANES, k, d)
    lanes = torch.arange(_LANES, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lanes ^ o]
    sums = acc[:, 0, 0]
    for w in range(1, LLOYD_THREADS // _LANES):
        sums = sums + acc[:, w, 0]
    counts = cnt.view(blocks, LLOYD_THREADS, k).sum(1).float()
    return torch.cat([sums.reshape(blocks, k * d), counts,
                      counts.new_zeros((blocks, 1))], dim=1)


def lloyd_sums_ref(x: torch.Tensor, idx: torch.Tensor, k: int, blocks: int):
    """(sums f32 (k, d), counts f32 (k,)) of x's rows by their labels
    ``idx`` in [0, k), bit for bit what ``csrc/fused.cu``'s narrow-row sums
    give on ``blocks`` blocks: :func:`lloyd_partials_ref`, then pass 2
    (:func:`reduce_partials_ref`)."""
    sums, counts, _ = reduce_partials_ref(
        lloyd_partials_ref(x, idx, k, blocks), k, x.shape[1])
    return sums, counts


# --- a plain model of the kernels' search (tests only) ---------------------

# The window's terms (csrc/assign_common.cuh derives them), one window per
# point: E = alpha(d) ||x|| cmax + 2^-21 (cnmax + 2 ||x|| cmax)
# + 2^-100 (||x|| + cmax + 1), cmax = max ||c||, cnmax = max ||c||^2; a
# point whose ||x|| cmax is not below 2^100 (or not finite) rechecks every
# centroid.
WINDOW_REL = 2.0 ** -21
WINDOW_ABS = 2.0 ** -100
WINDOW_GUARD = 2.0 ** 100


def window_alpha(d: int) -> float:
    """alpha(d) = (d + 64 ceil(d / 8) + 12) 2^-21."""
    return (d + 64 * (-(-d // 8)) + 12) * 2.0 ** -21


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 to its 10 leading mantissa bits, to the
    nearest with ties away from zero, on the int32 view (still fp32)."""
    v = v.float()
    bits = v.view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(v), r, v)


def _truncate(v: torch.Tensor, unit: torch.Tensor) -> torch.Tensor:
    """v cut toward zero to a multiple of unit (float64, exact)."""
    return torch.trunc(v / unit) * unit


def _mma_step(acc: torch.Tensor, products: torch.Tensor) -> torch.Tensor:
    """One k8 step of the tensor cores' fp32 accumulation, as the kernels'
    window models it: acc (n, k) and the 8 exact products (n, k, 8) are
    aligned to the largest addend's exponent e and cut to 24 bits (a
    multiple of 2^(e - 23)), summed exactly, and the sum cut to fp32."""
    terms = torch.cat([acc[..., None], products], dim=-1)
    _, exp = torch.frexp(terms)  # |t| in [2^(exp-1), 2^exp)
    exp = torch.where(terms == 0, torch.full_like(exp, -10000), exp)
    top = exp.max(-1).values
    one = torch.ones_like(acc)
    total = _truncate(terms, torch.ldexp(one, top - 24)[..., None]).sum(-1)
    _, texp = torch.frexp(total)
    return _truncate(total, torch.ldexp(one, texp - 24))


def tf32x3_scores(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) candidate scores ||c||^2 - 2 (x_lo.c_hi + x_hi.c_lo +
    x_hi.c_hi), hi = tf32(v), lo = tf32(v - hi), as the kernels issue them:
    for each 8 features the three products in that order, each a step of
    :func:`_mma_step` (exact products, truncating fp32 accumulation), then
    one rounding of cn - 2 cross."""
    x, c = x.float(), c.float()
    xh, ch = tf32_round(x), tf32_round(c)
    xl, cl = tf32_round(x - xh), tf32_round(c - ch)
    d = x.shape[1]
    pad = -d % 8
    xh, xl, ch, cl = (torch.nn.functional.pad(t.double(), (0, pad))
                      for t in (xh, xl, ch, cl))
    cross = torch.zeros((x.shape[0], c.shape[0]), dtype=torch.float64)
    for f in range(0, d + pad, 8):
        for a, b in ((xl, ch), (xh, cl), (xh, ch)):
            cross = _mma_step(cross, a[:, None, f:f + 8] * b[None, :, f:f + 8])
    cn = centroid_norms_ref(c).double()
    return (cn[None, :] - 2.0 * cross).float()


def score_window(x: torch.Tensor, c: torch.Tensor,
                 s_approx: torch.Tensor) -> torch.Tensor:
    """(n, k) E with |s_approx - s| <= E for the exact scores s of
    :func:`assign_scores_ref` (the same E along each row); +inf on the rows
    the guard sends to a full recheck."""
    x, c = x.float(), c.float()
    xn = centroid_norms_ref(x).double().sqrt()
    cnorm = centroid_norms_ref(c).double()
    cnmax = cnorm.max() if cnorm.numel() else cnorm.new_zeros(())
    cmax = cnmax.sqrt()
    guard = ~(xn * cmax < WINDOW_GUARD)
    e = (window_alpha(x.shape[1]) * xn * cmax
         + WINDOW_REL * (cnmax + 2.0 * xn * cmax)
         + WINDOW_ABS * (xn + cmax + 1.0))
    e = torch.where(guard, torch.full_like(e, float("inf")), e)
    return e[:, None].expand(-1, s_approx.shape[1]).float()


def _candidates(s_approx: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(n, k) bool: s~_j - E_j <= min_l (s~_l + E_l), NaN counting as a
    candidate (the kernels' test, !(lo > upper))."""
    s, e = s_approx.double(), window.double()
    hi = torch.where(torch.isnan(s + e), torch.full_like(s, float("inf")),
                     s + e)
    return ~(s - e > hi.min(1, keepdim=True).values)


def candidates_per_point(s_approx: torch.Tensor,
                         window: torch.Tensor) -> torch.Tensor:
    """(n,) how many centroids the window leaves for the exact recheck."""
    return _candidates(s_approx, window).sum(1)


def recheck_argmin(x: torch.Tensor, c: torch.Tensor, s_approx: torch.Tensor,
                   window: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmin int32 (n,), min score f32 (n,)) from approximate scores and
    their window: the candidates' scores are recomputed exactly and the
    first minimum among them wins.  Equals :func:`assign_scores_ref`
    whenever |s~ - s| <= E."""
    x, c = x.float(), c.float()
    exact = _exact_scores(x, c, centroid_norms_ref(c))
    masked = torch.where(_candidates(s_approx, window), exact,
                         torch.full_like(exact, float("inf")))
    arg = torch.argmin(masked, dim=1)
    return arg.to(torch.int32), exact.gather(1, arg[:, None])[:, 0]
