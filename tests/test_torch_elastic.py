"""Elastic restore on the port (the twin of
tests/test_launch.py::test_elastic_restore_roundtrip), and the sharded
fits' state moved between shard counts through a checkpoint: a DBSCAN and
a K-Means run written at p = 4 resume at p = 1, and the reverse, to the
labels of an uninterrupted run."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (
    CheckpointStore,
    emergency_save,
    restore_resharded,
)
from repro_torch.core import dbscan, distributed as dist, kmeans
from repro_torch.core.cancellation import CancellationToken, CancelReason

CPU = torch.device("cpu")


def mesh(p: int) -> dist.Mesh:
    return dist.Mesh((CPU,) * p)


def test_elastic_restore_roundtrip(tmp_path):
    """Save, restore with a placement_fn (independent of the save mesh)."""
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones((4,))}
    store.save(1, tree)

    def placement_fn(like, m):
        return {k: m.devices[0] for k in like}

    like = {k: np.zeros(tuple(v.shape), np.float32) for k, v in tree.items()}
    restored = restore_resharded(store, 1, like, mesh(4), placement_fn)
    for k, v in tree.items():
        assert isinstance(restored[k], torch.Tensor)
        assert restored[k].device == CPU
        assert torch.equal(restored[k], v)


def test_emergency_save_never_raises(tmp_path):
    store = CheckpointStore(str(tmp_path))
    out = emergency_save(store, 3, {"x": np.arange(4)}, "preempted")
    assert out is not None
    assert store.manifest(3)["metadata"]["reason"] == "preempted"

    class Broken:
        def __array__(self, *a, **k):
            raise RuntimeError("device lost")

    assert emergency_save(store, 4, {"x": Broken()}, "preempted") is None
    assert 4 not in store.steps()


def _stop_after_first_state(token):
    def on_state(_):
        token.cancel(CancelReason.PREEMPTION)
    return on_state


def _blobs(seed, n, d, clusters, spread):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6.0, 6.0, size=(clusters, d))
    x = centers[rng.integers(0, clusters, n)] + rng.normal(0, spread, (n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("p_from,p_to", [(4, 1), (1, 4)])
def test_dbscan_state_checkpointed_at_one_shard_count(tmp_path, p_from, p_to):
    x = _blobs(21, 240, 2, 3, 0.5)
    cfg = dbscan.DBSCANConfig(eps=0.5, min_pts=4)
    full, _ = dbscan.fit_resumable(torch.from_numpy(x), cfg)
    token = CancellationToken()
    _, state = dist.sharded_dbscan_fit_resumable(
        mesh(p_from), x, cfg, token,
        on_state=_stop_after_first_state(token), state_interval=2)
    store = CheckpointStore(str(tmp_path))
    store.save(1, state.as_tree())
    tree = store.restore(1, state.as_tree())
    done, _ = dist.sharded_dbscan_fit_resumable(
        mesh(p_to), x, cfg, state=dbscan.DBSCANRunState.from_tree(tree))
    assert torch.equal(done.labels, full.labels)


@pytest.mark.parametrize("p_from,p_to", [(4, 1), (1, 4)])
def test_kmeans_state_checkpointed_at_one_shard_count(tmp_path, p_from, p_to):
    x = _blobs(22, 320, 3, 5, 1.5)
    cfg = kmeans.KMeansConfig(k=5, max_iters=100, tol=1e-9)
    mask = np.ones(320, bool)
    c0 = kmeans.init_centroids(5, torch.from_numpy(x), cfg)
    full = kmeans.fit_cancellable(5, torch.from_numpy(x), kmeans.KMeansConfig(
        k=5, max_iters=100, tol=1e-9, use_kernel=False))
    token = CancellationToken()
    _, mid = dist.sharded_kmeans_fit_resumable(
        mesh(p_from), x, mask, cfg, token, centroids=c0,
        on_state=_stop_after_first_state(token), state_interval=3)
    store = CheckpointStore(str(tmp_path))
    store.save(1, mid)
    tree = restore_resharded(
        store, 1, mid, mesh(p_to),
        lambda like, m: {k: m.devices[0] for k in like})
    done, _ = dist.sharded_kmeans_fit_resumable(
        mesh(p_to), x, mask, cfg, centroids=tree["centroids"],
        start_iteration=int(tree["iteration"]))
    assert torch.equal(done.labels, full.labels)
    assert int(done.iterations) == int(full.iterations)
