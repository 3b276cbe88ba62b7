"""The DBSCAN neighbour kernels' pair test, modelled on the CPU.

``csrc/neighbor.cu`` forms a candidate c~ ~ d2 - eps^2 for every pair from
TF32 products on the tensor cores (coordinates, norms and eps^2 packed into
one product), counts the pairs with c~ < -E, drops those with c~ > E, and
recomputes the rest exactly.  The plain model in
``kernels/neighbor/ref.py`` (``candidate_scores``, ``pair_window``,
``classify``) is held here against ``epsilon_degree_ref`` and
``expand_frontier_ref``, the kernels' plain twins: the window must hold
every exact d2, and any candidates inside the window must give the twins'
bits after the recheck.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.neighbor import ref

DIMS = [1, 2, 4, 8, 9, 64, 226]
KINDS = ["blobs", "gaussian", "large", "cancellation", "pads", "boundary"]


@pytest.fixture(autouse=True)
def _one_thread():
    # small (n, n, 8) float64 steps: threads only contend with the other
    # test workers
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _quantile_eps(x, q=0.1):
    d2 = ref._sq_dists(x, x).double()
    off = d2[~torch.eye(x.shape[0], dtype=torch.bool)]
    return float(np.float32(np.sqrt(float(torch.quantile(off, q)))))


def _inputs(kind, d, seed):
    """(x, eps): float32 points and an eps that puts pairs either side."""
    rng = np.random.default_rng(seed)
    n = 160 if d >= 64 else 300
    if kind in ("blobs", "pads"):
        centres = rng.uniform(-10, 10, size=(6, d))
        sigma = rng.uniform(0.15, 0.8, size=6)
        lab = rng.integers(0, 6, size=n)
        x = centres[lab] + rng.normal(size=(n, d)) * sigma[lab, None]
        eps = float(np.sqrt(d))        # the paper's eps
        if kind == "pads":             # the service's far-diagonal ladder
            pads = np.zeros((40, d))
            pads[:, 0] = x.max() + 16 * eps * (1 + np.arange(40))
            x = np.concatenate([x, pads])
        return torch.from_numpy(x.astype(np.float32)), eps
    if kind == "gaussian":
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    elif kind == "large":
        x = torch.from_numpy((rng.normal(size=(n, d)) * 1e4)
                             .astype(np.float32))
    elif kind == "cancellation":   # far from the origin: the norms cancel
        x = torch.from_numpy((rng.normal(size=d) * 1e3
                              + rng.normal(size=(n, d)) * 1e-2)
                             .astype(np.float32))
    else:  # boundary: pairs at eps and one ulp either side
        x = torch.from_numpy((rng.normal(size=(n, d)) * 3).astype(np.float32))
        eps = float(np.float32(np.sqrt(float(ref._sq_dists(x[:1], x[1:2])))))
        near = [torch.nextafter(x[1:2], torch.full_like(x[1:2], s))
                for s in (float("inf"), -float("inf"))]
        return torch.cat([x] + near), eps
    return x, _quantile_eps(x)


def _model(x, eps, cols=None):
    xc = x if cols is None else cols
    approx = ref.candidate_scores(x, xc, eps)
    window = ref.pair_window(x, xc, eps)
    exact = ref._sq_dists(x, xc).double() - ref.eps_squared(eps)
    return approx, window, exact


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", DIMS)
def test_window_holds_every_exact_d2(d, kind):
    x, eps = _inputs(kind, d, seed=d * 7 + KINDS.index(kind))
    approx, window, exact = _model(x, eps)
    assert torch.isfinite(window).all() and torch.isfinite(approx).all()
    gap = (approx - exact).abs()
    assert (gap <= window).all(), float((gap / window).max())
    # the window is narrow where the norms do not cancel: few pairs
    # recheck (far from the origin every pair may, as it must; a tile of
    # far-diagonal pads widens the window of every row against it; wide
    # rows sum more k-steps, each widening the window)
    _, recheck = ref.classify(x, x, eps, approx, window)
    if kind != "cancellation":
        limit = (0.05 if kind == "pads" else 0.005) * (4 if d > 64 else 1)
        assert float(recheck.double().mean()) < limit


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", DIMS)
def test_recheck_of_adversarial_candidates_is_bit_exact(d, kind):
    x, eps = _inputs(kind, d, seed=d * 11 + KINDS.index(kind) + 1)
    rng = np.random.default_rng(d + 100 * KINDS.index(kind))
    front = torch.from_numpy(rng.random(x.shape[0]) < 0.1)
    front[0] = True

    def adversarial(cols):
        # any candidates inside the window, some on its edges
        window = ref.pair_window(x, cols, eps)
        exact = ref._sq_dists(x, cols).double() - ref.eps_squared(eps)
        u = torch.from_numpy(rng.uniform(-1.0, 1.0, size=exact.shape))
        u[:, ::7] = 1.0
        u[:, 3::7] = -1.0
        return ref.classify(x, cols, eps, exact + u * window, window)[0]

    assert torch.equal(adversarial(x).sum(1).to(torch.int32),
                       ref.epsilon_degree_ref(x, eps))
    assert torch.equal(adversarial(x[front]).any(1),
                       ref.expand_frontier_ref(x, front, eps))


@pytest.mark.parametrize("d", [1, 4, 9])
def test_model_counts_give_the_plain_bits(d):
    # the model's own candidates, not adversarial ones: what the card does
    x, eps = _inputs("blobs", d, seed=d)
    approx, window, _ = _model(x, eps)
    counted, recheck = ref.classify(x, x, eps, approx, window)
    assert torch.equal(counted.sum(1).to(torch.int32),
                       ref.epsilon_degree_ref(x, eps))
    assert bool(recheck.any())        # the recheck path is exercised


def test_non_finite_rows_and_huge_norms_recheck_in_full():
    x, eps = _inputs("gaussian", 4, seed=3)
    x[5, 2] = float("inf")
    x[9, 0] = float("nan")
    x[11] = 1e30                      # a finite point whose norm overflows
    window = ref.pair_window(x, x, eps)
    for i in (5, 9, 11):
        assert not torch.isfinite(window[i]).any()
    # every column tile holding one of them guards every row against it
    assert not torch.isfinite(window[:, :64]).any()
    assert torch.isfinite(window[[0, 1], 64:]).all()
    approx = ref.candidate_scores(x, x, eps)
    counted, _ = ref.classify(x, x, eps, approx, window)
    deg = ref.epsilon_degree_ref(x, eps)
    assert torch.equal(counted.sum(1).to(torch.int32), deg)
    assert int(deg[5]) == 0 and int(deg[9]) == 0 and int(deg[11]) == 1


def test_eps_zero_counts_exact_duplicates_only():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(100, 3)).astype(np.float32))
    x = torch.cat([x, x[:10], torch.nextafter(x[10:15], x[10:15] + 1)])
    approx, window, _ = _model(x, 0.0)
    counted, recheck = ref.classify(x, x, 0.0, approx, window)
    deg = ref.epsilon_degree_ref(x, 0.0)
    assert torch.equal(counted.sum(1).to(torch.int32), deg)
    assert int(deg[0]) == 2 and int(deg[10]) == 1 and int(deg[20]) == 1
    # the self pairs and the duplicates all sit inside the window
    assert bool(recheck.diagonal().all())


def test_kappa_and_ksteps():
    assert [ref.pack_ksteps(d) for d in (1, 2, 4, 5, 8, 9, 226)] == [
        1, 2, 2, 3, 4, 4, 86]
    assert ref.window_kappa(4) == (12 + 27 + 36) * 2.0 ** -22
