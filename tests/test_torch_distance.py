"""Port parity: the K-Means assignment wrapper against the reference's
Pallas kernel (interpret mode on the CPU).  The port's wrapper takes its
plain version for CPU tensors; on the card the same plain version is held
against the CUDA kernel by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.distance.ops import assign_clusters as jax_assign
from repro_torch.kernels.distance import ops as tops
from repro_torch.kernels.distance.ref import pairwise_sq_dists_ref

# The reference's own tolerance for fp32 distances (tests/test_kernels.py).
TOL = 2e-4


def _data(n, k, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 5).astype(np.float32)
    c = (rng.standard_normal((k, d)) * 5).astype(np.float32)
    return x, c


@pytest.mark.parametrize(
    "n,k,d",
    [
        (128, 2, 1),      # paper's smallest grid corner
        (1000, 6, 2),     # paper's figure example
        (2048, 8, 4),     # paper's largest feature count
        (513, 3, 2),      # n not divisible by the tile
        (256, 130, 2),    # k > one centroid tile
        (64, 5, 300),     # d > two lane tiles
    ],
)
def test_assign_matches_jax_kernel(n, k, d):
    x, c = _data(n, k, d, seed=n * 7 + k * 3 + d)
    jidx, jdist = jax_assign(jnp.asarray(x), jnp.asarray(c))
    idx, dist = tops.assign_clusters(torch.from_numpy(x), torch.from_numpy(c))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                               rtol=TOL, atol=TOL)


def test_assign_bf16_inputs_computed_in_fp32():
    x, c = _data(300, 7, 3, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    cb = torch.from_numpy(c).to(torch.bfloat16)
    jidx, jdist = jax_assign(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                             jnp.asarray(cb.float().numpy(), jnp.bfloat16))
    idx, dist = tops.assign_clusters(xb, cb)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_assign_first_minimum_wins_and_distance_is_exact():
    # duplicated centroids tie exactly: the lowest index must win
    x, c = _data(200, 4, 3, seed=9)
    c = np.concatenate([c, c])
    idx, dist = tops.assign_clusters(torch.from_numpy(x), torch.from_numpy(c))
    assert int(idx.max()) < 4
    full = pairwise_sq_dists_ref(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(dist.numpy(), full.min(1).values.numpy(),
                               rtol=TOL, atol=TOL)
    # a point sitting on a centroid: clamped at 0, never negative
    _, d0 = tops.assign_clusters(torch.from_numpy(c[:4]), torch.from_numpy(c))
    assert (d0.numpy() >= 0).all() and d0.numpy().max() < 1e-3


def test_assign_score_only_and_input_checks():
    x, c = _data(50, 3, 2, seed=1)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    idx, score = tops.assign_clusters(xt, ct, with_dists=False)
    idx2, dist = tops.assign_clusters(xt, ct)
    assert (idx == idx2).all()
    np.testing.assert_allclose((score + (xt * xt).sum(1)).clamp_min(0).numpy(),
                               dist.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tops.assign_clusters(xt, ct[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        tops.assign_clusters(xt.T.contiguous().T, ct)
    with pytest.raises(TypeError):
        tops.assign_clusters(xt.double(), ct.double())


def test_cpu_tensor_never_counts_a_launch():
    x, c = _data(64, 3, 2, seed=2)
    before = tops.assign_clusters.launches
    tops.assign_clusters(torch.from_numpy(x), torch.from_numpy(c))
    assert tops.assign_clusters.launches == before
