"""The work counts on small shapes, worked by hand."""

import pytest

from portbench import work


def test_search_counts():
    # n 3, k 2, d 4: 2 * 3 * 2 * 4 operations; x 12 floats, c 8, 3 + 3 out
    assert work.search(3, 2, 4) == (48, 4 * (12 + 8 + 6))


def test_lloyd_step_adds_the_sums():
    assert work.lloyd_step_flops(3, 2, 4) == 48 + 12


def test_degree_counts_unordered_pairs_with_self():
    # n 4: 10 unordered pairs (6 + the 4 points with themselves), d 2
    assert work.degree(4, 2) == (2 * 2 * 10, 4 * (8 + 4))


def test_roofline_takes_the_larger_bound():
    assert work.roofline_s(495e12, 0) == pytest.approx(1.0)
    assert work.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.roofline_s(495e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_cells_bounds():
    # the K-Means cell's search is bound by its bytes: the points read
    # once (256 MiB), an index and a distance written a point
    ops, nbytes = work.search(1 << 24, 8, 4)
    assert work.roofline_s(ops, nbytes) == pytest.approx(
        4 * ((1 << 24) * 4 + 8 * 4 + 2 * (1 << 24)) / 3.35e12)
    ops, _ = work.degree(524288, 4)
    assert work.roofline_s(*work.degree(524288, 4)) == pytest.approx(
        ops / 495e12)
