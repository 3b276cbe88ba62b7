"""The port's single-process clustering service against the reference.

Everything runs on the CPU (``device="cpu"``): the kernel lane's wrappers
take their plain versions there.  Data is made with numpy and handed to
both packages.  DBSCAN labels must equal the sequential oracle and the
reference executor's; K-Means through the port's ``cuda-kernel`` paradigm
must give the reference ``pallas-kernel`` paradigm's labels and iteration
count from the same initial centroids, with inertia and centroids within
1e-5.
"""

import os
import time

import numpy as np
import pytest
import torch

from repro.service import (
    AdmissionQueue as JaxQueue,
    BatchExecutor as JaxExecutor,
    MicroBatcher as JaxBatcher,
)
from repro.service.dispatch import ItemView as JaxItemView, JaxParadigm
from repro.service.queue import MiningRequest as JaxRequest
from repro_torch.core import dbscan, kmeans
from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.core.jobs import JobState
from repro_torch.kernels import _build
from repro_torch.service import (
    AdmissionQueue,
    BatchExecutor,
    ClusteringService,
    MicroBatcher,
    MiningClient,
    MiningRequest,
    ParadigmRegistry,
    TorchParadigm,
)
from repro_torch.service.batcher import BatchKey, MicroBatch
from repro_torch.service.dispatch import (
    EXECUTOR_CUDA,
    EXECUTOR_DISTRIBUTED,
    EXECUTOR_NUMPY_MT,
    EXECUTOR_TORCH_REF,
    ItemView,
)
from repro_torch.service.exec_cache import ExecutableCache

DB_CFG = dbscan.DBSCANConfig.paper_defaults(2)
DB_PARAMS = {"eps": DB_CFG.eps, "min_pts": DB_CFG.min_pts}
# the reference lane each port lane stands for
JAX_LANE = {EXECUTOR_CUDA: "pallas-kernel", EXECUTOR_TORCH_REF: "jax-ref",
            EXECUTOR_NUMPY_MT: "numpy-mt"}


def blob(seed, clusters=4, points=32, features=2, spread=0.5):
    """Gaussian blobs made with numpy, so both packages see the same data."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(clusters, features))
    x = np.concatenate([c + rng.normal(0.0, spread, size=(points, features))
                        for c in centers]).astype(np.float32)
    rng.shuffle(x)
    return x


def _one_batch(queue_cls, batcher_cls, requests, max_batch=4):
    q = queue_cls()
    b = batcher_cls(q, max_batch=max_batch, max_wait_s=0.0)
    for r in requests:
        q.submit(r)
    batches = b.poll()
    assert len(batches) == 1
    return batches[0]


@pytest.mark.parametrize("executor", [EXECUTOR_CUDA, EXECUTOR_TORCH_REF,
                                      EXECUTOR_NUMPY_MT])
def test_batch_dbscan_matches_oracle_and_reference(tmp_path, executor):
    # unequal lengths: the shorter item is padded to the bucket
    datasets = [blob(1, clusters=3, points=24), blob(2, clusters=3,
                                                     points=17)]
    batch = _one_batch(AdmissionQueue, MicroBatcher, [
        MiningRequest(f"t{i}", "dbscan", d, dict(DB_PARAMS),
                      executor=executor) for i, d in enumerate(datasets)])
    out = BatchExecutor(str(tmp_path / "port"), device="cpu").run_batch(batch)
    assert not out.suspended and out.executor == executor
    jbatch = _one_batch(JaxQueue, JaxBatcher, [
        JaxRequest(f"t{i}", "dbscan", d, dict(DB_PARAMS),
                   executor=JAX_LANE[executor])
        for i, d in enumerate(datasets)])
    jout = JaxExecutor(str(tmp_path / "jax")).run_batch(jbatch)
    for d, r, jr in zip(datasets, out.results, jout.results):
        oracle = dbscan.fit_oracle(d, DB_CFG)
        np.testing.assert_array_equal(r["labels"], oracle)
        np.testing.assert_array_equal(r["labels"], jr["labels"])
        assert r["n_clusters"] == jr["n_clusters"] == int(oracle.max())


def _kmeans_item(view_cls, x, n_max, c0):
    x_pad = np.zeros((n_max, x.shape[1]), np.float32)
    x_pad[: x.shape[0]] = x
    return view_cls(index=0, x_pad=x_pad, length=x.shape[0], seed=0,
                    mid_state={"centroids": c0, "iteration": np.int32(0)})


def _run_paradigm(paradigm, item, params):
    plan = paradigm.plan("kmeans", params, batch_size=1,
                         n_max=item.x_pad.shape[0],
                         features=item.x_pad.shape[1])
    done = {}
    outcome = paradigm.execute(
        plan, [item], None,
        lambda i, labels, scalars: done.update(labels=labels, **scalars),
        lambda i, tree: None)
    assert not outcome.suspended
    return done


@pytest.mark.parametrize("n_max", [256, 512])
def test_kmeans_kernel_lane_matches_reference_lane(n_max):
    x = blob(7, clusters=4, points=50, features=3, spread=0.3)  # 200 real
    c0 = x[[0, 50, 100, 150]].copy()
    params = {"k": 4, "max_iters": 50, "tol": 1e-6}
    ref = _run_paradigm(JaxParadigm("pallas-kernel", use_kernel=True),
                        _kmeans_item(JaxItemView, x, n_max, c0), params)
    got = _run_paradigm(TorchParadigm(EXECUTOR_CUDA, True, "cpu"),
                        _kmeans_item(ItemView, x, n_max, c0), params)
    np.testing.assert_array_equal(got["labels"], np.asarray(ref["labels"]))
    assert got["iterations"] == ref["iterations"] >= 2
    assert got["converged"] == ref["converged"]
    np.testing.assert_allclose(got["inertia"], ref["inertia"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["centroids"], ref["centroids"],
                               rtol=1e-5, atol=1e-5)


def test_service_end_to_end_multi_tenant(tmp_path):
    datasets = {i: blob(10 + i, clusters=3, points=24) for i in range(3)}
    with ClusteringService(str(tmp_path), max_batch=4, max_wait_s=0.005,
                           device="cpu") as svc:
        client = MiningClient(service=svc)
        handles = [
            client.submit(f"tenant-{i % 2}", "dbscan", d, params=DB_PARAMS,
                          executor=EXECUTOR_CUDA)
            for i, d in datasets.items()
        ]
        km = client.submit("tenant-0", "kmeans", datasets[0],
                           params={"k": 3, "seed": 1},
                           executor=EXECUTOR_CUDA)
        for i, h in enumerate(handles):
            labels = h.result(300)["labels"]
            np.testing.assert_array_equal(
                labels, dbscan.fit_oracle(datasets[i], DB_CFG))
        res = km.result(300)
        assert res["iterations"] >= 1 and res["executor"] == EXECUTOR_CUDA
        # duplicate submission: served from the cache, no recompute
        dup = client.submit("tenant-9", "dbscan", datasets[0],
                            params=DB_PARAMS, executor=EXECUTOR_CUDA)
        assert dup.cache_hit and dup.result(5)["n_clusters"] >= 1
    snap = svc.metrics_snapshot()
    assert snap["requests"] == 5 and snap["cache_hits"] == 1
    assert snap["batches"] >= 1 and 0.0 < snap["mean_occupancy"] <= 1.0
    # one lane per registered paradigm, the distributed one included
    assert set(snap["lanes"]) == {EXECUTOR_CUDA, EXECUTOR_TORCH_REF,
                                  EXECUTOR_NUMPY_MT, EXECUTOR_DISTRIBUTED}


@pytest.mark.parametrize("executor", [EXECUTOR_CUDA, EXECUTOR_TORCH_REF])
def test_preempt_mid_batch_then_resume(tmp_path, executor):
    datasets = [blob(40 + i, clusters=8, points=64) for i in range(2)]
    oracles = [dbscan.fit_oracle(d, DB_CFG) for d in datasets]
    batch = _one_batch(AdmissionQueue, MicroBatcher, [
        MiningRequest(f"t{i}", "dbscan", d, dict(DB_PARAMS),
                      executor=executor) for i, d in enumerate(datasets)])
    ex = BatchExecutor(str(tmp_path), checkpoint_every=2, device="cpu")
    token = CancellationToken()

    def hook(job_id, item, events):
        if events == 3:   # mid-batch, mid-item
            token.cancel(CancelReason.PREEMPTION)

    out = ex.run_batch(batch, token=token, progress_hook=hook)
    assert out.suspended
    job = ex.jobs.get(out.job_id)
    assert job.state == JobState.SUSPENDED
    assert job.checkpoint_path and os.path.exists(job.checkpoint_path)

    ex2 = BatchExecutor(str(tmp_path), checkpoint_every=2, device="cpu")
    outcomes = ex2.resume_suspended()
    assert len(outcomes) == 1 and not outcomes[0].suspended
    assert outcomes[0].resumed and outcomes[0].executor == executor
    for oracle, r in zip(oracles, outcomes[0].results):
        np.testing.assert_array_equal(r["labels"], oracle)
    assert ex2.jobs.get(out.job_id).state == JobState.SUCCEEDED


def _uniform(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-5.0, 5.0, size=(n, d)).astype(np.float32)


def test_join_fills_freed_slot_without_a_new_cache_miss(tmp_path):
    params = {"k": 4, "max_iters": 300, "tol": 1e-6}
    first = MiningRequest("t-first", "kmeans", _uniform(256, 2, seed=5),
                          dict(params, seed=5))
    joiner = MiningRequest("t-join", "kmeans", blob(6, points=64),
                           dict(params, seed=6))
    cache = ExecutableCache()
    reg = ParadigmRegistry(device="cpu")
    reg.register(TorchParadigm(EXECUTOR_CUDA, True, "cpu", exec_cache=cache))
    ex = BatchExecutor(str(tmp_path), registry=reg, checkpoint_every=4)
    handed, retired = [], []

    def join_source(free_slots):
        assert free_slots >= 1
        if not handed:
            handed.append(joiner)
            return [joiner]
        return []

    def on_retire(req, result):
        retired.append(req.tenant)
        req.resolve(result)

    batch = MicroBatch(key=BatchKey.for_request(first), requests=[first],
                       capacity=2)
    outcome = ex.run_batch(batch, executor=EXECUTOR_CUDA, continuous=True,
                           join_source=join_source, on_retire=on_retire)
    assert outcome.joined == 1 and outcome.retired == 2
    assert outcome.size == 2 and joiner.job_id == outcome.job_id
    assert sorted(retired) == ["t-first", "t-join"]
    st = cache.stats()
    assert st["misses"] == 1 and st["hits"] >= 1 and st["entries"] == 1
    for req, seed in ((first, 5), (joiner, 6)):
        ref = kmeans.fit_cancellable(
            seed, torch.from_numpy(req.data),
            kmeans.KMeansConfig(k=4, max_iters=300, tol=1e-6,
                                use_kernel=False))
        np.testing.assert_array_equal(req.wait(1)["labels"],
                                      ref.labels.numpy())


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusteringService(str(tmp_path / "svc"))
    assert not (tmp_path / "svc").exists()   # nothing written on the host
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchExecutor(str(tmp_path / "ex")).run_batch(_one_batch(
            AdmissionQueue, MicroBatcher,
            [MiningRequest("t", "kmeans", blob(1), {"k": 4},
                           executor=EXECUTOR_CUDA)]))


def _failing_build(name, signatures):
    raise _build.KernelBuildError(f"nvcc refused {name}.cu")


def test_failed_kernel_build_raises_and_never_serves_the_plain_step(
        monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "library", _failing_build)
    monkeypatch.setattr(_build, "_libs", {})
    cache = ExecutableCache()
    cfg = kmeans.KMeansConfig(k=4, use_kernel=True)
    with pytest.raises(_build.KernelBuildError):
        cache.kmeans_step(1024, 2, cfg, device="cuda")
    with pytest.raises(_build.KernelBuildError):
        cache.warm_kmeans(1024, 2, cfg, device="cuda")
    assert cache.stats()["entries"] == 0
    # the plain lane needs no build
    plain = cache.kmeans_step(1024, 2, kmeans.KMeansConfig(k=4,
                                                           use_kernel=False),
                              device="cuda")
    assert plain.func is kmeans.masked_kmeans_step
    # service warm-up of a CUDA kernel lane raises from start()
    reg = ParadigmRegistry(device="cpu")
    reg.register(TorchParadigm(EXECUTOR_CUDA, True, "cuda",
                               exec_cache=ExecutableCache()))
    svc = ClusteringService(
        str(tmp_path), registry=reg, device="cpu",
        warm_start=[{"algo": "kmeans", "features": 2, "n": 1000, "k": 4,
                     "executor": EXECUTOR_CUDA}])
    with pytest.raises(_build.KernelBuildError):
        svc.start()
    assert not svc._running
    svc.stop()


def test_warm_start_prepares_the_bucket_once(tmp_path):
    with ClusteringService(
            str(tmp_path), device="cpu", max_batch=1, max_wait_s=0.0,
            bucket_policy="pow2",
            warm_start=[{"algo": "kmeans", "features": 2, "n": 100,
                         "k": 4}]) as svc:
        before = svc.exec_cache.stats()
        client = MiningClient(service=svc)
        h = client.submit("t", "kmeans", blob(3, points=25),
                          params={"k": 4, "seed": 2},
                          executor=EXECUTOR_CUDA)
        assert h.result(120)["iterations"] >= 1
        after = svc.exec_cache.stats()
    assert after["warmed"] >= 1
    assert after["misses"] == before["misses"]   # the warmed key was hit
    assert after["hits"] > before["hits"]


def test_stream_session_on_the_service_device(tmp_path):
    with ClusteringService(str(tmp_path), device="cpu") as svc:
        client = MiningClient(service=svc)
        x = blob(21, clusters=4, points=100)
        with client.stream("t", "s", k=4, batch_size=64, seed=3) as stream:
            assert stream.push(x[:200]) >= 1
            labels = stream.assign(x[:10])
            snap = stream.snapshot()
        assert labels.dtype == np.int16 and labels.shape == (10,)
        assert snap["initialized"] and snap["n_seen"] == 192
        # reopening resumes the checkpointed model
        again = client.stream("t", "s", k=4, batch_size=64, seed=3)
        np.testing.assert_array_equal(again.snapshot()["centroids"],
                                      stream.snapshot()["centroids"])


def test_service_preempt_then_resume_in_a_new_service(tmp_path):
    data = blob(60, clusters=8, points=128)
    oracle = dbscan.fit_oracle(data, DB_CFG)
    svc = ClusteringService(str(tmp_path), max_batch=1, max_wait_s=0.0,
                            checkpoint_every=1, device="cpu").start()
    h = MiningClient(service=svc).submit("t0", "dbscan", data,
                                         params=DB_PARAMS,
                                         executor=EXECUTOR_CUDA)
    deadline = time.time() + 30
    while h.job_id is None and time.time() < deadline:
        time.sleep(0.005)
    svc.stop(preempt=True)
    svc2 = ClusteringService(str(tmp_path), device="cpu")
    outcomes = svc2.resume_suspended()
    if h.exception(1) is None:     # a fast machine may outrun the preempt
        assert outcomes == []
        np.testing.assert_array_equal(h.result(1)["labels"], oracle)
    else:
        assert len(outcomes) == 1 and not outcomes[0].suspended
        np.testing.assert_array_equal(outcomes[0].results[0]["labels"],
                                      oracle)
