"""The K-Means kernels' search, modelled on the CPU.

``csrc/distance.cu`` and ``csrc/fused.cu`` score every (point, centroid)
pair with three TF32 products on the tensor cores, keep the centroids whose
window [s~ - E, s~ + E] reaches below the best upper end, and recompute
those exactly.  The plain model in ``kernels/distance/ref.py``
(``tf32x3_scores``, ``score_window``, ``recheck_argmin``) is held here
against ``assign_scores_ref``, the kernels' plain twin: the window must hold
every exact score, and any scores inside the window must give the twin's
index and score bits after the recheck.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.distance import ref

DIMS = [1, 2, 9, 32, 300]
KINDS = ["blobs", "gaussian", "large", "cancellation"]


def _inputs(kind, d, seed, n=1500, k=48):
    rng = np.random.default_rng(seed)
    if kind == "blobs":
        centers = rng.uniform(-10, 10, size=(k, d))
        x = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))
        c = x[rng.choice(n, size=k, replace=False)]
    elif kind == "gaussian":
        x = rng.normal(size=(n, d))
        c = rng.normal(size=(k, d))
    elif kind == "large":
        x = rng.normal(size=(n, d)) * 1e4
        c = rng.normal(size=(k, d)) * 1e4
    else:  # far from the origin: ||c||^2 - 2 x.c cancels to a small score
        offset = rng.normal(size=d) * 1e3
        x = offset + rng.normal(size=(n, d)) * 1e-2
        c = offset + rng.normal(size=(k, d)) * 1e-2
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(c.astype(np.float32)))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", DIMS)
def test_tf32x3_scores_stay_inside_the_window(d, kind):
    x, c = _inputs(kind, d, seed=d * 7 + KINDS.index(kind))
    exact = ref._exact_scores(x, c, ref.centroid_norms_ref(c))
    approx = ref.tf32x3_scores(x, c)
    window = ref.score_window(x, c, approx)
    assert torch.isfinite(window).all()
    gap = (approx.double() - exact.double()).abs()
    assert (gap <= window.double()).all(), float((gap / window).max())
    # the window is narrow: most points keep one candidate (where the
    # scores cancel to below the fp32 noise of ||x|| ||c||, every centroid
    # stays a candidate, as it must)
    if kind != "cancellation":
        cands = ref.candidates_per_point(approx, window).double()
        assert float(cands.mean()) < 1.5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", DIMS)
def test_recheck_of_adversarial_scores_is_bit_exact(d, kind):
    x, c = _inputs(kind, d, seed=d * 11 + KINDS.index(kind) + 1)
    idx, score = ref.assign_scores_ref(x, c)
    exact = ref._exact_scores(x, c, ref.centroid_norms_ref(c))
    window = ref.score_window(x, c, ref.tf32x3_scores(x, c))
    rng = np.random.default_rng(d + 100 * KINDS.index(kind))
    u = torch.from_numpy(rng.uniform(-1.0, 1.0, size=exact.shape))
    adversarial = exact.double() + u * window.double()
    got_idx, got_score = ref.recheck_argmin(x, c, adversarial, window)
    assert torch.equal(got_idx, idx)
    assert torch.equal(_bits(got_score), _bits(score))


def test_tf32_round_is_round_to_nearest_away():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, float("inf"),
                      0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0, float("inf"), 0.0],
                        dtype=torch.float32)
    assert torch.equal(ref.tf32_round(v), want)
    assert bool(torch.isnan(ref.tf32_round(torch.tensor([float("nan")])))
                .all())


def test_mma_step_truncates_to_the_largest_addend():
    # addends below the largest's last bit vanish; the sum is cut toward
    # zero, never rounded up
    one = torch.ones((1, 1), dtype=torch.float64)
    tiny = torch.full((1, 1, 8), 2.0 ** -30, dtype=torch.float64)
    assert float(ref._mma_step(one, tiny)) == 1.0
    assert float(ref._mma_step(-one, tiny)) == -1.0 + 0.0
    assert float(ref._mma_step(-one, -tiny)) == -1.0
    three = torch.tensor([[[2.0 ** -23 * 0.75] * 8]], dtype=torch.float64)
    assert float(ref._mma_step(one, three)) == 1.0
    # exact when every addend sits on the grid: 1 + 8 * 2^-23, then cut
    grid = torch.full((1, 1, 8), 2.0 ** -23, dtype=torch.float64)
    assert float(ref._mma_step(one, grid)) == 1.0 + 8 * 2.0 ** -23
    # the sum's own cut: (2^24 - 1) + 1 + 1 is 2^24 + 1, cut to 2^24
    big = torch.full((1, 1), 2.0 ** 24 - 1, dtype=torch.float64)
    ones = torch.tensor([[[1.0, 1.0] + [0.0] * 6]], dtype=torch.float64)
    assert float(ref._mma_step(big, ones)) == 2.0 ** 24


def test_window_sends_non_finite_points_to_a_full_recheck():
    x, c = _inputs("gaussian", 4, seed=3, n=6, k=5)
    x[1, 2] = float("inf")
    x[3, 0] = float("nan")
    approx = ref.tf32x3_scores(x, c)
    window = ref.score_window(x, c, approx)
    assert not torch.isfinite(window[[1, 3]]).any()
    assert (ref.candidates_per_point(approx, window)[[1, 3]] == 5).all()
    idx, score = ref.recheck_argmin(x, c, approx, window)
    ridx, rscore = ref.assign_scores_ref(x, c)
    assert torch.equal(idx, ridx)
    assert torch.equal(_bits(score), _bits(rscore))
