"""The plain reference against cases worked by hand, and the DBSCAN
reference's pruned blocks against an unpruned brute force."""

import numpy as np
import pytest
import torch

from portbench.reference import common
from portbench.reference import dbscan as ref_dbscan
from portbench.reference import kmeans as ref_kmeans


def _col(*v):
    return torch.tensor(v, dtype=torch.float32)[:, None]


def test_lloyd_by_hand():
    x = _col(0.0, 1.0, 10.0, 11.0)
    r = ref_kmeans.lloyd(x, _col(0.0, 10.0), 1)
    assert r["labels"].tolist() == [0, 0, 1, 1]
    assert r["centroids"][:, 0].tolist() == [0.5, 10.5]
    assert r["inertia"] == 2.0          # against the initial centroids
    r = ref_kmeans.lloyd(x, _col(0.0, 10.0), 2)
    assert r["inertia"] == 1.0          # against [0.5, 10.5]


def test_empty_cluster_keeps_its_place():
    r = ref_kmeans.lloyd(_col(0.0, 1.0, 2.0), _col(1.0, 100.0), 3)
    assert r["centroids"][:, 0].tolist() == [1.0, 100.0]


def test_update_gap_by_hand():
    x = _col(0.0, 1.0, 10.0, 11.0)
    labels = torch.tensor([0, 0, 1, 1])
    assert ref_kmeans.update_gap(x, labels, _col(0.5, 10.5)) == 0.0
    assert ref_kmeans.update_gap(x, labels, _col(0.5, 10.625)) == (
        pytest.approx(0.125 / 11.0))


def test_lloyd_keeps_the_last_steps_centroids():
    x = _col(0.0, 1.0, 10.0, 11.0)
    r = ref_kmeans.lloyd(x, _col(0.0, 10.0), 2)
    assert r["last"][:, 0].tolist() == [0.5, 10.5]
    assert r["centroids"][:, 0].tolist() == [0.5, 10.5]


def test_label_mismatch_by_hand():
    x = _col(0.0, 1.0, 10.0, 11.0)
    c = _col(0.5, 10.5)
    assert ref_kmeans.label_mismatch(x, c, torch.tensor([0, 0, 1, 1])) == 0
    assert ref_kmeans.label_mismatch(x, c, torch.tensor([1, 0, 1, 0])) == 2
    # out of range counts; an exact tie excuses either label
    assert ref_kmeans.label_mismatch(x, c, torch.tensor([0, 0, 1, 2])) == 1
    assert ref_kmeans.label_mismatch(_col(5.5), c, torch.tensor([1])) == 0


def test_label_mismatch_excuses_float32_rounding_only():
    # two centroids 2^-20 apart in squared distance from the point, far
    # inside float32's rounding of scores of norm 2e4, and two 0.5 apart
    x = torch.tensor([[100.0, 100.0]])
    near = torch.tensor([[101.0, 100.0], [100.0, 101.0 + 2.0 ** -21]])
    assert ref_kmeans.label_mismatch(x, near, torch.tensor([1])) == 0
    far = torch.tensor([[101.0, 100.0], [100.0, 101.25]])
    assert ref_kmeans.label_mismatch(x, far, torch.tensor([1])) == 1


def test_tf32_rounds_to_ten_mantissa_bits():
    v = torch.tensor([1.0 + 2.0**-12, 1.0 + 2.0**-11, -(1.0 + 2.0**-11),
                      3.0], dtype=torch.float32)
    assert common.tf32(v).tolist() == [1.0, 1.0 + 2.0**-10,
                                       -(1.0 + 2.0**-10), 3.0]


def test_tf32_lloyd_moves_the_update():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2048, 8), generator=g) * 3 + 7
    c0 = x[:16].clone()
    exact = ref_kmeans.lloyd(x, c0, 3)
    low = ref_kmeans.lloyd(x, c0, 3, "tf32")
    assert ref_kmeans.update_gap(x, exact["labels"], exact["centroids"]) < 1e-6
    assert ref_kmeans.update_gap(x, low["labels"], low["centroids"]) > 1e-5


def _line(order):
    """1-D points with a zero second feature: A = 6 points 0..5/8, B = 6
    points 2.375..3, a border point 1.5 within eps (1) of A's 4/8, 5/8 and
    B's 2.375, 2.5 (degree 5 < min_pts 6), and a noise point 9."""
    a = [i / 8 for i in range(6)]
    b = [2.375 + i / 8 for i in range(6)]
    pts = {"a": a, "b": b, "p": [1.5], "z": [9.0]}
    vals = [v for key in order for v in pts[key]]
    x = torch.tensor(vals, dtype=torch.float32)
    return torch.stack([x, torch.zeros_like(x)], 1), vals


@pytest.mark.parametrize("order,first", [("abpz", "a"), ("bzpa", "b"),
                                         ("pzab", "a")])
def test_dbscan_by_hand(order, first):
    x, vals = _line(order)
    labels, core, degree = ref_dbscan.fit(x, 1.0, 6)
    a_id = 1 if first == "a" else 2
    b_id = 3 - a_id
    # the border point 1.5 reaches A's 4/8, 5/8 and B's 2.375, 2.5
    assert degree[vals.index(1.5)] == 5 and degree[vals.index(9.0)] == 1
    for v, lab, c in zip(vals, labels.tolist(), core.tolist()):
        if v == 9.0:
            assert (lab, c) == (0, False)
        elif v == 1.5:   # border of both: the first cluster found takes it
            assert (lab, c) == (a_id if first == "a" else b_id, False)
        elif v < 1.0:
            assert (lab, c) == (a_id, True)
        else:
            assert (lab, c) == (b_id, True)


def test_pair_at_exactly_eps_is_within():
    x = torch.tensor([[0.0, 0.0], [0.0, 2.0]], dtype=torch.float32)
    labels, core, degree = ref_dbscan.fit(x, 2.0, 2)
    assert labels.tolist() == [1, 1] and core.tolist() == [True, True]
    assert degree.tolist() == [2, 2]
    labels, core, degree = ref_dbscan.fit(
        x, float(np.nextafter(np.float32(2.0), np.float32(0))), 2)
    assert labels.tolist() == [0, 0] and core.tolist() == [False, False]
    assert degree.tolist() == [1, 1]


def _brute(x, eps, min_pts):
    x = x.numpy()
    n = x.shape[0]
    d2 = np.zeros((n, n), np.float32)
    for f in range(x.shape[1]):
        t = x[:, None, f] - x[None, :, f]
        d2 = d2 + t * t
    adj = d2 <= ref_dbscan.eps_squared(eps)
    degree = adj.sum(1)
    core = degree >= min_pts
    labels = np.zeros(n, np.int32)
    cid = 0
    for s in range(n):
        if not core[s] or labels[s]:
            continue
        cid += 1
        front = np.zeros(n, bool)
        front[s] = True
        while front.any():
            new = adj[:, front].any(1) & (labels == 0)
            labels[new] = cid
            front = new & core
    return labels, core, degree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_blocks_equal_the_brute_force(seed):
    g = torch.Generator().manual_seed(seed)
    # first features on a coarse grid, so many pairs sit at the band's edge
    x = torch.cat([torch.randint(0, 40, (700, 1), generator=g) * 0.5,
                   torch.rand((700, 2), generator=g) * 6], 1).float()
    labels, core, degree = ref_dbscan.fit(x, 1.0, 5)
    want_labels, want_core, want_degree = _brute(x, 1.0, 5)
    assert degree.tolist() == want_degree.tolist()
    assert core.tolist() == want_core.tolist()
    assert labels.tolist() == want_labels.tolist()
    assert (labels == 0).any() and labels.max() > 1
