"""The inputs: the configurations' datasets bit for bit as the blobs
generator drew them when it was ``inputs.make_points``, and the initial
draw's k distinct indices, the same wherever they are drawn."""

import hashlib

import pytest
import torch

from portbench import inputs

from portbench.tests.sizes import small_config

# sha256 over datasets 0-3 of each small configuration (kmeans-d4 at
# 8 x 512 points, dbscan-d4 at 8 x 256), as the parent of the generators'
# lookup by name drew them
DRAWN = {
    ("kmeans-d4", 7):
        "5bc57a7fbef4b377ec635b6841dc2e452b7cbf42d6cd6ff8d7bd187a899cd3a5",
    ("kmeans-d4", 2**31 + 11):
        "41fb885d215e8d1c3e3803bc672df7240bb93948c711040f4a22e8b613506cd5",
    ("dbscan-d4", 7):
        "85d425731ba81cbfa8cd3bc04c56f4f5cfba75e881dde7405585763dc75585ec",
    ("dbscan-d4", 2**31 + 11):
        "0258d0b0c8b7f021e069fd543979d4246902c9caa0ef188021a6b91cd75f7d17",
}


@pytest.mark.parametrize("config,seed", sorted(DRAWN))
def test_datasets_are_bit_equal_to_the_old_draw(config, seed):
    h = hashlib.sha256()
    for x in inputs.datasets(small_config(config), seed, 4,
                             torch.device("cpu")):
        assert x.dtype == torch.float32 and x.is_contiguous()
        h.update(x.numpy().tobytes())
    assert h.hexdigest() == DRAWN[config, seed]


def test_the_initial_indices_are_pinned():
    # drawn on the host, so the card and the CPU start from these rows
    assert inputs.initial_indices(1 << 24, 8, 2**31 + 11, 0) == [
        5645720, 810552, 10399202, 9879461, 4879219, 500419, 7984377,
        15511218]


@pytest.mark.parametrize("n,k", [(1 << 24, 8), (100, 100), (5, 1), (7, 0)])
def test_the_initial_indices_are_distinct_rows(n, k):
    for job in range(20):
        idx = inputs.initial_indices(n, k, 2**33 + 1, job)
        assert len(idx) == len(set(idx)) == k
        assert all(0 <= i < n for i in idx)
    assert inputs.initial_indices(n, k, 5, 1) == \
        inputs.initial_indices(n, k, 5, 1)
    with pytest.raises(ValueError):
        inputs.initial_indices(n, n + 1, 5, 1)


def test_each_row_is_drawn_alike():
    # 3 of 6 rows, 3,000 jobs: each row 1,500 times, give or take
    seen = [0] * 6
    for job in range(3000):
        for i in inputs.initial_indices(6, 3, 11, job):
            seen[i] += 1
    assert all(1350 < s < 1650 for s in seen), seen


def test_initial_centroids_gather_those_rows():
    x = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    c = inputs.initial_centroids(x, 3, 9, 2)
    assert c.is_contiguous() and c.shape == (3, 4)
    assert torch.equal(c, x[inputs.initial_indices(10, 3, 9, 2)])
