"""The port's fused masked Lloyd step against the reference's fused kernel.

The reference runs its Pallas kernel in interpret mode on the CPU (as
``tests/test_fused_kernel.py`` does); the port's wrapper takes its plain
version for CPU tensors.  Assignments must be equal; sums, counts,
centroids, shift and inertia agree within rtol = atol = 1e-5 (the two
packages sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkmeans
from repro.kernels.distance.fused import (
    fused_masked_assign_update as jax_fused,
)
from repro_torch.core import kmeans
from repro_torch.kernels.distance import fused, ops
from repro_torch.kernels.distance.ref import fused_masked_assign_update_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(n, k, d, seed, n_real=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    mask = np.arange(n) < (n if n_real is None else n_real)
    return x, c, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _cfg(k, use_kernel=True):
    return kmeans.KMeansConfig(k=k, use_kernel=use_kernel)


CASES = [
    (128, 4, 2, None),    # full batch, no padding
    (256, 8, 4, 200),     # padded tail carries no weight
    (64, 8, 2, 8),        # mostly padding (a near-empty joined slot)
    (96, 16, 3, 96),      # k big relative to n: empty clusters likely
    (5, 8, 2, 5),         # k > n — every surplus centroid stays empty
    (513, 6, 7, 400),     # nothing divides the tile sizes
]


@pytest.mark.parametrize("n,k,d,n_real", CASES)
def test_fused_update_matches_reference_kernel(n, k, d, n_real):
    x, c, mask = _problem(n, k, d, seed=n * 31 + k, n_real=n_real)
    ref = jax_fused(jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask))
    before = fused.fused_masked_assign_update.launches
    got = fused.fused_masked_assign_update(*_t(x, c, mask))
    assert fused.fused_masked_assign_update.launches == before  # CPU: twin
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for r, g, name in zip(ref[1:], got[1:], ("sums", "counts", "inertia")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("n,k,d,n_real", CASES)
def test_fused_step_matches_reference_step(n, k, d, n_real):
    x, c, mask = _problem(n, k, d, seed=n * 31 + k, n_real=n_real)
    jcfg = jkmeans.KMeansConfig(k=k, use_kernel=True)
    ref = jkmeans.fused_masked_kmeans_step(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask), jcfg)
    got = kmeans.fused_masked_kmeans_step(*_t(x, c, mask), _cfg(k))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for r, g, name in zip(ref[1:], got[1:], ("centroids", "shift",
                                              "inertia")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)
    # and the port's own two-pass step agrees with its fused step
    plain = kmeans.masked_kmeans_step(*_t(x, c, mask), _cfg(k, False))
    assert torch.equal(plain[0], got[0])
    for p, g in zip(plain[1:], got[1:]):
        torch.testing.assert_close(g, p, **TOL)


def test_empty_clusters_keep_old_centers():
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 0.01, size=(64, 2)).astype(np.float32)
    c = np.array([[0.0, 0.0], [50.0, 50.0], [-50.0, 50.0], [50.0, -50.0]],
                 np.float32)
    mask = np.ones((64,), bool)
    assign, c_new, _, _ = kmeans.fused_masked_kmeans_step(
        *_t(x, c, mask), _cfg(4))
    np.testing.assert_array_equal(assign.numpy(), np.zeros(64))
    np.testing.assert_array_equal(c_new.numpy()[1:], c[1:])
    np.testing.assert_allclose(c_new.numpy()[0], x.mean(0), rtol=1e-5,
                               atol=1e-6)
    jref = jkmeans.fused_masked_kmeans_step(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask),
        jkmeans.KMeansConfig(k=4))
    np.testing.assert_allclose(c_new.numpy(), np.asarray(jref[1]), **TOL)


def test_fully_masked_batch_is_inert():
    x, c, _ = _problem(32, 4, 2, seed=7)
    mask = np.zeros((32,), bool)
    _, c_new, shift, inertia = kmeans.fused_masked_kmeans_step(
        *_t(x, c, mask), _cfg(4))
    np.testing.assert_array_equal(c_new.numpy(), c)
    assert float(shift) == 0.0
    assert float(inertia) == 0.0


def test_raw_fused_accumulators_match_manual():
    x, c, mask = _problem(200, 6, 3, seed=3, n_real=150)
    idx, sums, counts, inertia = fused_masked_assign_update_ref(
        *_t(x, c, mask))
    w = mask.astype(np.float32)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    ref_idx = d2.argmin(1)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    onehot = np.eye(6, dtype=np.float32)[ref_idx] * w[:, None]
    np.testing.assert_allclose(sums.numpy(), onehot.T @ x, **TOL)
    np.testing.assert_array_equal(counts.numpy(), onehot.sum(0))
    np.testing.assert_allclose(float(inertia), float((d2.min(1) * w).sum()),
                               rtol=1e-5)


def test_masked_step_fn_routes_by_config():
    assert kmeans.masked_step_fn(_cfg(4, False)) is kmeans.masked_kmeans_step
    assert (kmeans.masked_step_fn(_cfg(4))
            is kmeans.fused_masked_kmeans_step)
    x, c, mask = _problem(128, 4, 2, seed=11, n_real=100)
    ref = kmeans.masked_step_fn(_cfg(4, False))(*_t(x, c, mask),
                                                _cfg(4, False))
    got = kmeans.masked_step_fn(_cfg(4))(*_t(x, c, mask), _cfg(4))
    assert torch.equal(ref[0], got[0])
    torch.testing.assert_close(got[1], ref[1], **TOL)


def test_wrapper_checks_inputs():
    x, c, mask = _t(*_problem(16, 3, 2, seed=1))
    with pytest.raises(ValueError, match="mask must be bool"):
        fused.fused_masked_assign_update(x, c, mask.float())
    with pytest.raises(TypeError, match="float32"):
        fused.fused_masked_assign_update(x.double(), c.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_masked_assign_update(x.T.contiguous().T, c, mask)


def test_launch_shape_bounds_the_partials():
    # the service shape: ~1M rows, 64 clusters of 32 features, tiles of 128
    tpb, blocks, acc_k = fused.launch_shape(1 << 20, 64, 32)
    assert blocks <= 1024 and tpb * blocks * 128 >= 1 << 20
    assert acc_k == 64
    # large k: the sums of all 1024 centroids fit one shared-memory range,
    # partials stay under 2^24 floats
    tpb, blocks, acc_k = fused.launch_shape(65536, 1024, 32)
    assert blocks * (1024 * 32 + 1024 + 1) <= 1 << 24
    assert acc_k == 1024
    # wide rows: smaller tiles, and the sums take several ranges
    p = ops.plan(3000, 600, 128)
    tpb, blocks, acc_k = fused.launch_shape(3000, 600, 128)
    assert p.tm == 64 and tpb * blocks * p.tm >= 3000
    assert 1 <= acc_k < 600
    assert fused.launch_shape(5, 8, 2) == (1, 1, 8)


@pytest.mark.parametrize("n,k,d", [(1 << 20, 64, 32), (65536, 1024, 32),
                                   (300, 70, 300), (64, 5, 300), (1, 1, 1),
                                   (3000, 600, 128), (10, 3, 900),
                                   (4096, 64, 1024), (300, 70, 1561),
                                   (300, 1, 1751), (300, 64, 1815),
                                   (100, 8, 4096)])
def test_search_plan_fits_a_block(n, k, d):
    # the ring, the chunk slots and the fused step's sums fit 227 KB
    for p in (ops.plan(n, k, d), fused._plan(n, k, d)[0]):
        assert p.tm % 16 == 0 and 16 <= p.tm <= 128 and p.nt in (1, 2, 4, 8)
        assert p.wide == (d > ops.WIDE_D)
        if p.wide:  # the sums' 64-row tiles; the search on its own grid
            assert p.tm == 64 and not p.resident and p.slots == 0
            assert p.nt == 8 or 8 * p.nt >= k
            if k <= 8:  # the exact form: a lane for every pair, at once
                kp = 1 << (k - 1).bit_length()
                assert p.stages == 0 and not p.xres and p.nt == 1
                assert p.search_blocks == -(-n * kp // 64)
            else:  # the TF32 form: 128-point tiles, one block an SM
                assert 2 <= p.stages <= 8
                assert p.search_blocks == -(-n // 128)
                assert ops.search_grid(p, 132) == min(-(-n // 128), 132)
                assert p.xres <= (k > 8 * p.nt)
        else:
            assert p.slots == (-(-k // (8 * p.nt)) if p.resident else 1)
            assert (p.stages, p.xres, p.search_blocks) == (0, False, 0)
        assert p.blocks * p.tiles_per_block * p.tm >= n
        assert (p.blocks - 1) * p.tiles_per_block * p.tm < n
    assert ops.assign_bytes(d, ops.plan(n, k, d)) <= ops.MAX_SMEM
    fp, acc_k = fused._plan(n, k, d)
    assert 1 <= acc_k <= k
    assert ops.fused_bytes(d, fp, acc_k) <= ops.MAX_SMEM
    assert ops.assign_bytes(d, fp) <= ops.MAX_SMEM
    if fp.wide:
        # the search: 1 KB of alignment slack, x's resident tile as TF32
        # hi and lo images (128-row boxes), the ring of box steps (x's box
        # unless resident, the chunk's hi and lo boxes), 2 stages + 2
        # mbarriers, the 128 rows' best keys and recheck counts; none for
        # the exact form.  The sums: acc_k centroids' sums and counts, and
        # two warps' inertia
        stage = (0 if fp.xres else 128 * 128) + 16 * fp.nt * 128
        search = (0 if fp.stages == 0 else
                  1024 + fp.xres * 2 * ops.boxes(d) * 128 * 128
                  + fp.stages * stage + 8 * (2 * fp.stages + 2) + 128 * 12)
        assert ops.assign_bytes(d, fp) == search
        assert ops.fused_bytes(d, fp, acc_k) == 4 * acc_k * (d + 1) + 16
        return
    # the bytes are the sum of the parts: 1 KB of alignment slack, the
    # ring of whole tiles, the chunk slots, the fused step's arrays, two
    # mbarriers
    ring = 2 * ops.boxes(d) * fp.tm * 128
    parts = (1024 + ring + fp.slots * ops.chunk_bytes(d, fp.nt)
             + 4 * (acc_k * (d + 1) + 3 * fp.tm) + 16)
    assert parts <= ops.fused_bytes(d, fp, acc_k) <= parts + 4


# The wide search at the paths' shapes: the embedding fit (n 1,024, d 2,048,
# k 4), the pod-scale K-Means step (2^24 x 128, k 4,096) whole, at a 2-shard
# shard and at a 16-shard shard, and the "search forms" rows' wide shapes.
@pytest.mark.parametrize("n,k,d", [(1024, 4, 2048), (1 << 24, 4096, 128),
                                   (8118720, 4096, 128), (541248, 4096, 128),
                                   (65536, 64, 128), (65536, 64, 192),
                                   (16384, 64, 1024)])
def test_wide_plan_at_the_paths_shapes(n, k, d):
    p = ops.plan(n, k, d)
    fp, acc_k = fused._plan(n, k, d)
    assert p.wide and fp.wide
    assert (p.nt, p.stages, p.xres, p.search_blocks) == (
        fp.nt, fp.stages, fp.xres, fp.search_blocks)
    if k <= 8:
        # every (point, centroid) pair has a lane of its own, and every
        # lane is in flight at once (at most 32 blocks an SM)
        assert p.stages == 0 and p.search_blocks * 64 >= n * 4
        assert p.search_blocks <= 132 * 32
    else:
        # one block on every SM of an H100 while there are tiles for it
        assert p.search_blocks == -(-n // 128)
        assert ops.search_grid(p, 132) == min(132, -(-n // 128))
        # x's tile stays across the chunks where there are several and its
        # two images fit beside a ring of two
        assert p.xres == (k > 64 and d <= 192)
        assert 4 <= p.stages <= 8
    assert ops.assign_bytes(d, p) <= ops.MAX_SMEM
    assert ops.fused_bytes(d, fp, acc_k) <= ops.MAX_SMEM
    # block_rows is a whole number of the sums' 64-row tiles, and at the
    # pod-scale cell it is what it was (the partials' bits stand)
    rows = fused.block_rows(n, k, d)
    assert rows % 64 == 0 and rows == fp.tiles_per_block * 64
    if (n, k) == (1 << 24, 4096):
        assert rows == 541248 and fp.blocks == 31 and acc_k == 450


# The wide search's grid follows the card it launches on (an H100 SXM's 132
# SMs, a PCIe card's 114, smaller cards); the plan, and so every bit, does
# not.  The TF32 form's persistent grid takes at most a block an SM; the
# exact form's blocks each hold their own lanes.
@pytest.mark.parametrize("sms", [132, 114, 78, 1])
@pytest.mark.parametrize("n,k,d", [(1024, 4, 2048), (8118720, 4096, 128),
                                   (1, 9, 97), (65536, 64, 1024)])
def test_wide_search_grid_follows_the_card(n, k, d, sms):
    p = ops.plan(n, k, d)
    grid = ops.search_grid(p, sms)
    if p.stages == 0:
        assert grid == p.search_blocks and grid * 64 >= n * 4
    else:
        assert 1 <= grid <= sms and grid == min(sms, p.search_blocks)
        assert p.search_blocks == -(-n // 128)
    assert p == ops.plan(n, k, d)
    assert fused._plan(n, k, d)[0].search_blocks == p.search_blocks


def test_search_plan_keeps_the_widest_rows():
    # the CUDA-core kernels these replaced took rows of up to 1815
    # features (assignment) and 1751 (fused step, k = 1; 1561 for k >= 5);
    # every width up to there and well past it gets a plan that fits, and
    # the fused step keeps the sums of several centroids at a time
    for d in range(1, 4097):
        for k in (1, 64):
            p = ops.plan(4096, k, d)
            assert ops.assign_bytes(d, p) <= ops.MAX_SMEM, (d, k)
            fp, acc_k = fused._plan(4096, k, d)
            assert ops.fused_bytes(d, fp, acc_k) <= ops.MAX_SMEM, (d, k)
            assert acc_k >= min(k, 8), (d, k)
    # the main path's shapes keep whole rows, 128-point tiles and chunks
    # of 64 centroids
    for n, k, d in ((1 << 20, 64, 32), (65536, 1024, 32)):
        p = ops.plan(n, k, d)
        assert (p.wide, p.tm, p.nt) == (False, 128, 8)
