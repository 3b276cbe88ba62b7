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
