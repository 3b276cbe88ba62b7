"""The port's distributed lane on the CPU: meshes that repeat the host
device (``Mesh((cpu,) * p)``) run p shards in one process.

For p in {1, 2, 3, 4, 8}, with n divisible by p and not: the ring degree
and expansion equal the plain versions bit for bit; the sharded masked
Lloyd step gives the single-device assignment with centroids within 1e-5,
and the fused step's two passes over the whole item bit for bit at every
p (its shards are cut at the step's blocks); the sharded fits give the
single-device labels and
iteration counts; a run preempted at one shard count resumes at another to
the same labels.  The cross twins summed over random row and column splits
equal the whole-x plain versions.  Against the reference, the same numpy
inputs go through ``repro.core.distributed`` on its in-process one-device
CPU mesh: ring degrees and expansions equal on coordinates where the
reference's decomposed d2 is exact (a quarter grid, the reference's
blobs), and the sharded K-Means step's assignment equal with centroids
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import kmeans as jkmeans
from repro.data.synthetic import ClusterSpec, make_blobs
from repro_torch.core import dbscan, distributed as dist, kmeans
from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.kernels.distance import fused
from repro_torch.kernels.neighbor import ops as nops, ref as nref

CPU = torch.device("cpu")
SHARDS = [1, 2, 3, 4, 8]


def mesh(p: int) -> dist.Mesh:
    return dist.Mesh((CPU,) * p)


def points(seed: int, n: int, d: int = 3, clusters: int = 4,
           spread: float = 0.6) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6.0, 6.0, size=(clusters, d))
    x = centers[rng.integers(0, clusters, n)] + rng.normal(0, spread, (n, d))
    return torch.from_numpy(x.astype(np.float32))


def frontier(seed: int, n: int, frac: float = 0.1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(n) < frac)


def sizes(p: int):
    """n divisible by p, and n not divisible by p (where p > 1)."""
    return [24 * p, 24 * p + 1] if p > 1 else [24, 25]


SHAPES = [(p, n) for p in SHARDS for n in sizes(p)]


@pytest.mark.parametrize("p,n", SHAPES)
def test_ring_degree_and_expand_equal_the_plain_versions(p, n):
    x = points(p * 100 + n, n)
    f = frontier(n, n)
    m = mesh(p)
    assert torch.equal(dist.ring_degree(m, x, 1.5),
                       nref.epsilon_degree_ref(x, 1.5))
    assert torch.equal(dist.ring_expand(m, x, f, 1.5),
                       nref.expand_frontier_ref(x, f, 1.5))
    # a ring call takes shards as well as a whole tensor
    xs = dist.shard(m, x)
    assert len(xs) == p and sum(s.shape[0] for s in xs) == n
    assert torch.equal(dist.ring_degree(m, xs, 1.5),
                       nref.epsilon_degree_ref(x, 1.5))


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("extra", [0, 77])
def test_sharded_masked_step_gives_the_single_device_step(p, extra):
    # 2 blocks of the fused step's 128 rows a shard (and 77 rows more):
    # every shard holds rows
    n = 256 * p + extra
    x = points(p + n, n)
    mask = torch.arange(n) < n - 5          # padded rows carry no weight
    cfg = kmeans.KMeansConfig(k=4)
    c0 = x[:4].clone()
    bounds = dist.kmeans_bounds(n, 4, 3, p)
    assert all(b > a for a, b in bounds) and bounds[-1][1] == n
    assign, c, shift, inertia = dist.make_sharded_masked_kmeans_step(
        mesh(p), cfg)(x, c0, mask)
    ra, rc, rshift, rinertia = kmeans.masked_step_fn(cfg)(x, c0, mask, cfg)
    assert torch.equal(assign, ra)
    np.testing.assert_allclose(c.numpy(), rc.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(inertia), float(rinertia), rtol=1e-5)
    np.testing.assert_allclose(float(shift), float(rshift), rtol=1e-5,
                               atol=1e-5)
    # the fused step's two passes over the whole item: the same bits at
    # every shard count (the shards write the one launch's partials)
    rows = fused.block_rows(n, 4, 3)
    _, part = fused.fused_masked_partials(x, c0, mask, rows)
    sums, counts, whole_inertia = fused.reduce_partials(part, 4, 3)
    whole_c, whole_shift = kmeans.update_from_partials(c0, sums, counts)
    assert torch.equal(c, whole_c) and torch.equal(shift, whole_shift)
    assert torch.equal(inertia, whole_inertia)


def test_sharded_step_refuses_shards_off_the_blocks():
    x = points(0, 600)
    step = dist.make_sharded_masked_kmeans_step(mesh(2),
                                                kmeans.KMeansConfig(k=4))
    m = torch.ones(600, dtype=torch.bool)
    with pytest.raises(ValueError):
        step([x[:100], x[100:]], x[:4].clone(), [m[:100], m[100:]])


@pytest.mark.parametrize("seed", range(4))
def test_cross_twins_summed_over_random_splits_equal_the_whole(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 200))
    x = points(seed, n, d=int(rng.integers(1, 6)))
    f = frontier(seed + 7, n, 0.2)
    cuts = np.unique(np.concatenate([[0, n], rng.integers(0, n, 4)]))
    deg = torch.zeros(n, dtype=torch.int32)
    reach = torch.zeros(n, dtype=torch.bool)
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        col_cuts = np.unique(np.concatenate([[0, n],
                                             rng.integers(0, n, 3)]))
        for c0, c1 in zip(col_cuts[:-1], col_cuts[1:]):
            rows, cols = x[r0:r1], x[c0:c1]
            deg[r0:r1] += nops.epsilon_degree_cross(rows, cols, 1.2)
            reach[r0:r1] |= nops.expand_frontier_cross(rows, cols, f[c0:c1],
                                                       1.2)
    assert torch.equal(deg, nref.epsilon_degree_ref(x, 1.2))
    assert torch.equal(reach, nref.expand_frontier_ref(x, f, 1.2))


def test_cross_wrappers_take_empty_sets_and_refuse_bad_inputs():
    x = points(0, 10)
    empty = x[:0]
    assert torch.equal(nops.epsilon_degree_cross(x, empty, 1.0),
                       torch.zeros(10, dtype=torch.int32))
    assert nops.expand_frontier_cross(empty, x, frontier(0, 10), 1.0) \
        .shape == (0,)
    with pytest.raises(ValueError):
        nops.epsilon_degree_cross(x, x[:, :2].contiguous(), 1.0)
    with pytest.raises(ValueError):
        nops.expand_frontier_cross(x, x, frontier(0, 9), 1.0)


# --- against the reference ---------------------------------------------------


def _quarter_grid(seed, n, d):
    rng = np.random.default_rng(seed)
    return (rng.integers(-24, 24, (n, d)) / 4.0).astype(np.float32)


def _reference_blobs(seed, clusters=4, points_per=64, features=2):
    x, _, _ = make_blobs(jax.random.PRNGKey(seed),
                         ClusterSpec(features, clusters, points_per))
    return np.array(x, np.float32)


INPUTS = [("grid", lambda: _quarter_grid(1, 96, 3), 1.5),
          ("grid eps 0", lambda: _quarter_grid(2, 96, 2), 0.0),
          ("blobs", lambda: _reference_blobs(3), float(np.sqrt(2.0))),
          ("blobs 4d", lambda: _reference_blobs(4, 8, 32, 4), 2.0)]


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("what,make,eps", INPUTS,
                         ids=[i[0] for i in INPUTS])
def test_ring_matches_the_reference_ring(p, what, make, eps):
    xn = make()
    n = xn.shape[0]
    fn = np.random.default_rng(n).random(n) < 0.1
    jmesh = jdist.local_mesh()
    jdeg = np.asarray(jdist.ring_degree(jmesh, jnp.asarray(xn), eps))
    jreach = np.asarray(jdist.ring_expand(jmesh, jnp.asarray(xn),
                                          jnp.asarray(fn), eps))
    m = mesh(p)
    deg = dist.ring_degree(m, torch.from_numpy(xn), eps)
    reach = dist.ring_expand(m, torch.from_numpy(xn), torch.from_numpy(fn),
                             eps)
    np.testing.assert_array_equal(deg.numpy(), jdeg)
    np.testing.assert_array_equal(reach.numpy(), jreach)


@pytest.mark.parametrize("p", SHARDS)
def test_sharded_kmeans_step_matches_the_reference(p):
    xn = _reference_blobs(5, clusters=4, points_per=48)
    cn = xn[[0, 50, 100, 150]].copy()
    jcfg = jkmeans.KMeansConfig(k=4, use_kernel=False)
    ja, jc, jshift, jinertia = jdist.make_sharded_kmeans_step(
        jdist.local_mesh(), jcfg)(jnp.asarray(xn), jnp.asarray(cn))
    a, c, shift, inertia = dist.make_sharded_kmeans_step(
        mesh(p), kmeans.KMeansConfig(k=4))(torch.from_numpy(xn),
                                           torch.from_numpy(cn))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(inertia), float(jinertia), rtol=1e-5)
    np.testing.assert_allclose(float(shift), float(jshift), rtol=1e-5,
                               atol=1e-5)


# --- the resumable fits -------------------------------------------------------


@pytest.mark.parametrize("p", SHARDS)
def test_sharded_dbscan_fit_gives_the_single_device_labels(p):
    x = points(11, 203, d=2, spread=0.5)
    cfg = dbscan.DBSCANConfig(eps=0.6, min_pts=5)
    valid = torch.arange(203) < 200
    result, state = dist.sharded_dbscan_fit_resumable(
        mesh(p), x.numpy(), cfg, valid_mask=valid.numpy())
    ref, _ = dbscan.fit_resumable(x, cfg, valid_mask=valid)
    assert state is None and not result.cancelled
    assert torch.equal(result.labels, ref.labels)
    assert torch.equal(result.core_mask, ref.core_mask)
    assert int(result.expansions) == int(ref.expansions)
    assert int(result.n_clusters) == int(ref.n_clusters) >= 2
    oracle = dbscan.fit_oracle(x[:200].numpy(), cfg)
    np.testing.assert_array_equal(result.labels[:200].numpy(), oracle)


@pytest.mark.parametrize("p", SHARDS)
def test_sharded_kmeans_fit_gives_the_single_device_labels(p):
    x = points(12, 300, d=2, clusters=4)
    cfg = kmeans.KMeansConfig(k=4, max_iters=60)
    c0 = kmeans.init_centroids(3, x, cfg)
    result, mid = dist.sharded_kmeans_fit_resumable(
        mesh(p), x, torch.ones(300, dtype=torch.bool), cfg,
        centroids=c0)
    ref = kmeans.fit_cancellable(3, x, kmeans.KMeansConfig(
        k=4, max_iters=60, use_kernel=False))
    assert mid is None and not result.cancelled
    assert torch.equal(result.labels, ref.labels)
    assert int(result.iterations) == int(ref.iterations)
    np.testing.assert_allclose(result.centroids.numpy(),
                               ref.centroids.numpy(), rtol=1e-5, atol=1e-5)


def _cancel_after_first_state(token):
    def on_state(_):
        token.cancel(CancelReason.PREEMPTION)
    return on_state


@pytest.mark.parametrize("p_from,p_to", [(4, 1), (4, 3), (1, 4), (3, 8)])
def test_dbscan_preempted_at_one_shard_count_resumes_at_another(p_from,
                                                                 p_to):
    x = points(13, 256, d=2, clusters=3, spread=0.5)
    cfg = dbscan.DBSCANConfig(eps=0.5, min_pts=4)
    full, _ = dist.sharded_dbscan_fit_resumable(mesh(p_to), x, cfg)
    token = CancellationToken()
    part, state = dist.sharded_dbscan_fit_resumable(
        mesh(p_from), x, cfg, token,
        on_state=_cancel_after_first_state(token), state_interval=2)
    assert part.cancelled and state is not None and state.nexp >= 2
    tree = state.as_tree()                   # what the checkpoint holds
    done, again = dist.sharded_dbscan_fit_resumable(
        mesh(p_to), x, cfg, state=dbscan.DBSCANRunState.from_tree(tree))
    assert again is None and not done.cancelled
    assert torch.equal(done.labels, full.labels)
    assert int(done.expansions) == int(full.expansions)


@pytest.mark.parametrize("p_from,p_to", [(4, 1), (4, 3), (1, 4), (3, 8)])
def test_kmeans_preempted_at_one_shard_count_resumes_at_another(p_from,
                                                                p_to):
    x = points(14, 400, d=3, clusters=5, spread=1.5)
    cfg = kmeans.KMeansConfig(k=5, max_iters=200, tol=1e-9)
    mask = torch.ones(400, dtype=torch.bool)
    c0 = kmeans.init_centroids(4, x, cfg)
    full, _ = dist.sharded_kmeans_fit_resumable(mesh(p_to), x, mask, cfg,
                                                centroids=c0)
    token = CancellationToken()
    part, mid = dist.sharded_kmeans_fit_resumable(
        mesh(p_from), x, mask, cfg, token, centroids=c0,
        on_state=_cancel_after_first_state(token), state_interval=2)
    assert part.cancelled and int(mid["iteration"]) == 2
    done, again = dist.sharded_kmeans_fit_resumable(
        mesh(p_to), x, mask, cfg, centroids=mid["centroids"],
        start_iteration=int(mid["iteration"]))
    assert again is None
    assert torch.equal(done.labels, full.labels)
    assert int(done.iterations) == int(full.iterations)


def test_mesh_and_sharding_rules():
    assert dist.local_mesh(device="cpu").devices == (CPU,)
    assert dist.local_mesh("rows", "cpu").axis == "rows"
    with pytest.raises(ValueError):
        dist.Mesh(())
    with pytest.raises(ValueError):     # the ring names the mesh's axis
        dist.ring_degree(mesh(2), points(0, 8), 1.0, axis="model")
    assert [dist.shard_rows(n, 4) for n in (0, 1, 8, 9)] == [0, 1, 2, 3]
    # 9 rows over 4 shards of 3: the last shard is empty
    assert [s.shape[0] for s in dist.shard(mesh(4), points(0, 9))] == [
        3, 3, 3, 0]
    m = dist.Mesh(("cpu", "cpu"))
    assert m.devices == (CPU, CPU) and m.size == 2 and hash(m) == hash(
        dist.Mesh((CPU, CPU)))
