"""The port's checkpoint store: round trips, the reference's on-disk layout
in both directions, CRC verification and keep-last GC."""

import os

import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.core import dbscan as jdbscan
from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    CheckpointCorrupt,
    CheckpointStore,
    tree_flatten_with_path,
)
from repro_torch.core import dbscan


def _batch_state(seed=0, size=2, n_max=16, d=3, k=4):
    """A K-Means batch-state tree as the batch executor builds it."""
    rng = np.random.default_rng(seed)
    return {
        "data": rng.normal(size=(size, n_max, d)).astype(np.float32),
        "labels": rng.integers(0, k, size=(size, n_max)).astype(np.int16),
        "done": np.array([True, False]),
        "occupied": np.ones((size,), bool),
        "active": np.asarray(True),
        "item": np.int32(1),
        "inertia": rng.random(size).astype(np.float32),
        "iterations": np.array([7, 3], np.int32),
        "converged": np.array([True, False]),
        "n_clusters": np.zeros((size,), np.int32),
        "noise": np.zeros((size,), np.int32),
        "expansions": np.zeros((size,), np.int32),
        "mid.centroids": rng.normal(size=(k, d)).astype(np.float32),
        "mid.iteration": np.int32(3),
    }


def _dbscan_tree(seed=1, n=40):
    rng = np.random.default_rng(seed)
    return dbscan.DBSCANRunState(
        packed=rng.integers(0, 200, size=n).astype(np.int16),
        frontier=rng.random(n) < 0.3, cid=5, nexp=17).as_tree()


def _like(tree):
    return {k: np.zeros_like(np.asarray(v)) for k, v in tree.items()}


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        g = np.asarray(got[key])
        w = np.asarray(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_round_trip_host_and_device(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = _batch_state()
    path = store.save(0, tree, metadata={"params": {"k": 4}})
    assert os.path.basename(path) == "step_0"
    assert store.manifest(0)["metadata"] == {"params": {"k": 4}}
    host = store.restore(0, _like(tree))
    _assert_tree_equal(host, tree)
    assert isinstance(host["data"], np.ndarray)
    dev = store.restore(0, _like(tree), device="cpu")
    assert isinstance(dev["data"], torch.Tensor)
    _assert_tree_equal({k: v.numpy() for k, v in dev.items()}, tree)


def test_tensor_leaves_and_nested_structure(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"b": [torch.arange(3), (torch.ones(2), None)],
            "a": {"z": np.float32(2.5), "y": 7}}
    names = [".".join(map(str, p)) for p, _ in tree_flatten_with_path(tree)]
    # dict keys sorted, list/tuple indices, None dropped (the jax order)
    assert names == ["a.y", "a.z", "b.0", "b.1.0"]
    store.save(3, tree)
    like = {"b": [np.zeros(3, np.int64), (np.zeros(2, np.float32), None)],
            "a": {"z": np.float32(0), "y": 0}}
    out = store.restore(3, like)
    assert out["b"][1][1] is None and isinstance(out["b"][1], tuple)
    np.testing.assert_array_equal(out["b"][0], [0, 1, 2])
    assert float(out["a"]["z"]) == 2.5 and int(out["a"]["y"]) == 7


@pytest.mark.parametrize("make", [_batch_state, _dbscan_tree])
def test_reference_checkpoint_restores_in_port(tmp_path, make):
    tree = make()
    JaxStore(str(tmp_path)).save(2, tree, metadata={"from": "jax"})
    store = CheckpointStore(str(tmp_path))
    assert store.latest_step() == 2
    _assert_tree_equal(store.restore(2, _like(tree)), tree)


@pytest.mark.parametrize("make", [_batch_state, _dbscan_tree])
def test_port_checkpoint_restores_in_reference(tmp_path, make):
    tree = make()
    CheckpointStore(str(tmp_path)).save(4, tree)
    jstore = JaxStore(str(tmp_path))
    restored = jstore.restore(4, _like(tree))
    _assert_tree_equal({k: np.asarray(v) for k, v in restored.items()}, tree)
    if make is _dbscan_tree:
        state = jdbscan.DBSCANRunState.from_tree(restored)
        assert state.cid == 5 and state.nexp == 17


def test_crc_detects_corruption(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = _batch_state()
    path = store.save(1, tree)
    fname = store.manifest(1)["leaves"]["data"]["file"]
    fpath = os.path.join(path, fname)
    raw = bytearray(open(fpath, "rb").read())
    raw[-1] ^= 0xFF   # flip the last data byte
    open(fpath, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorrupt, match="crc"):
        store.restore(1, _like(tree))
    # a wrong target shape is refused too
    like = _like(tree)
    like["labels"] = np.zeros((1, 1), np.int16)
    with pytest.raises(CheckpointCorrupt, match="shape"):
        store.restore(1, like, verify=False)


def test_keep_last_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=2)
    for step in range(5):
        store.save(step, {"x": np.full(3, step, np.int32)})
    assert store.steps() == [3, 4]
    assert int(store.restore(4, {"x": np.zeros(3, np.int32)})["x"][0]) == 4


def test_async_checkpointer_commits_in_order(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=10)
    ck = AsyncCheckpointer(store)
    x = torch.zeros(4)
    for step in range(3):
        x += 1   # updated in place after submit: the snapshot must hold
        ck.submit(step, {"x": x})
    ck.wait()
    assert store.steps() == [0, 1, 2]
    for step in range(3):
        got = store.restore(step, {"x": np.zeros(4, np.float32)})["x"]
        np.testing.assert_array_equal(got, np.full(4, step + 1, np.float32))
