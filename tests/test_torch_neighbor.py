"""Port parity: the DBSCAN neighbourhood wrappers against the reference's
Pallas kernels (interpret mode on the CPU).  Results must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.neighbor.ops import epsilon_degree as jax_degree
from repro.kernels.neighbor.ops import expand_frontier as jax_expand
from repro_torch.kernels.neighbor import ops as tops


def _points(n, d, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "n,d,eps",
    [
        (256, 1, 1.0),
        (600, 2, 1.4142135),   # paper: eps = sqrt(features)
        (1025, 4, 2.0),
        (129, 2, 0.5),
    ],
)
def test_degree_matches_jax_kernel(n, d, eps):
    x = _points(n, d, seed=n + d)
    ref = np.asarray(jax_degree(jnp.asarray(x), eps))
    deg = tops.epsilon_degree(torch.from_numpy(x), eps)
    assert deg.dtype == torch.int32
    np.testing.assert_array_equal(deg.numpy(), ref)


@pytest.mark.parametrize("n,d", [(256, 2), (600, 4), (1025, 1)])
def test_expand_matches_jax_kernel(n, d):
    x = _points(n, d, seed=n * 31 + d)
    f = np.random.default_rng(n).random(n) < 0.05
    eps = float(np.sqrt(d))
    ref = np.asarray(jax_expand(jnp.asarray(x), jnp.asarray(f), eps))
    reach = tops.expand_frontier(torch.from_numpy(x), torch.from_numpy(f), eps)
    assert reach.dtype == torch.bool
    np.testing.assert_array_equal(reach.numpy(), ref)


def test_expand_empty_frontier():
    x = _points(128, 2, seed=3, scale=1.0)
    f = np.zeros(128, bool)
    ref = np.asarray(jax_expand(jnp.asarray(x), jnp.asarray(f), 1.0))
    reach = tops.expand_frontier(torch.from_numpy(x), torch.from_numpy(f), 1.0)
    assert not reach.any() and not ref.any()


def test_degree_includes_self():
    # isolated far-apart points: degree exactly 1 (self)
    x = np.arange(64, dtype=np.float32)[:, None] * 100.0
    ref = np.asarray(jax_degree(jnp.asarray(x), 1.0))
    deg = tops.epsilon_degree(torch.from_numpy(x), 1.0)
    assert (deg.numpy() == 1).all() and (ref == 1).all()


def test_single_point_reach_equals_its_degree():
    x = torch.from_numpy(_points(200, 3, seed=4, scale=2.0))
    deg = tops.epsilon_degree(x, 1.5)
    for i in (0, 57, 199):
        f = torch.zeros(200, dtype=torch.bool)
        f[i] = True
        reach = tops.expand_frontier(x, f, 1.5)
        assert reach[i] and int(reach.sum()) == int(deg[i])


def test_input_checks():
    x = torch.from_numpy(_points(20, 2, seed=1))
    with pytest.raises(TypeError):
        tops.epsilon_degree(x.double(), 1.0)
    with pytest.raises(ValueError):
        tops.expand_frontier(x, torch.zeros(19, dtype=torch.bool), 1.0)
    with pytest.raises(ValueError):
        tops.expand_frontier(x, torch.zeros(20, dtype=torch.int32), 1.0)


def _both(x, eps, seed):
    """(JAX degree, port degree, JAX reach, port reach) on the same input,
    a ~20% frontier holding the first three points."""
    f = np.random.default_rng(seed).random(x.shape[0]) < 0.2
    f[:3] = True
    return (np.asarray(jax_degree(jnp.asarray(x), eps)),
            tops.epsilon_degree(torch.from_numpy(x), eps).numpy(),
            np.asarray(jax_expand(jnp.asarray(x), jnp.asarray(f), eps)),
            tops.expand_frontier(torch.from_numpy(x), torch.from_numpy(f),
                                 eps).numpy())


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_non_finite_row_matches_jax_kernel(bad):
    # a NaN or inf coordinate makes every d2 of its point NaN or inf:
    # degree 0 (itself included), reached by nothing, reaching nothing
    x = _points(300, 4, seed=11)
    x[7, 1] = bad
    jdeg, deg, jreach, reach = _both(x, 2.0, seed=1)
    np.testing.assert_array_equal(deg, jdeg)
    np.testing.assert_array_equal(reach, jreach)
    assert deg[7] == 0 and not reach[7]


def test_eps_zero_counts_duplicates_like_jax_kernel():
    # coordinates on a quarter grid: the reference's decomposition
    # ||a||^2 - 2 a.b + ||b||^2 is exact there too, so both count exactly
    # the duplicates (on random coordinates it rounds some duplicates'
    # d2 away from 0; the port's direct form never does)
    x = np.round(_points(300, 4, seed=12) * 4) / 4
    x = np.concatenate([x, x[:20]]).astype(np.float32)
    jdeg, deg, jreach, reach = _both(x, 0.0, seed=2)
    np.testing.assert_array_equal(deg, jdeg)
    np.testing.assert_array_equal(reach, jreach)
    assert (deg[:20] == 2).all() and (deg[300:] == 2).all()


@pytest.mark.parametrize("pads", [60, 2000])
def test_far_diagonal_pads_match_jax_kernel(pads):
    # the service's padding (dispatch.far_diagonal_pad): feature 0 on a
    # ladder 16 eps apart above the data, every pad isolated
    x = _points(300, 4, seed=13)
    x = np.concatenate([x, np.zeros((pads, 4), np.float32)])
    x[300:, 0] = x[:300].max() + 16 * 2.0 * (1 + np.arange(pads))
    jdeg, deg, jreach, reach = _both(x, 2.0, seed=3)
    np.testing.assert_array_equal(deg, jdeg)
    np.testing.assert_array_equal(reach, jreach)
    assert (deg[300:] == 1).all()


@pytest.mark.parametrize("n,d", [(1, 1), (2, 2), (63, 4), (64, 4), (65, 4),
                                 (127, 8), (129, 9), (70, 10), (65, 64),
                                 (33, 226), (300, 3), (257, 5), (100, 17)])
def test_cpu_tensors_take_the_plain_version(monkeypatch, n, d):
    # on the CPU the wrappers never reach the library (no nvcc, no card),
    # and agree with the reference's kernels at ragged n and every width
    # class (one box a point: d <= 9; streamed boxes beyond)
    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(tops, "_lib", no_library)
    x = _points(n, d, seed=5 * n + d)
    jdeg, deg, jreach, reach = _both(x, float(np.sqrt(d)), seed=n)
    np.testing.assert_array_equal(deg, jdeg)
    np.testing.assert_array_equal(reach, jreach)
