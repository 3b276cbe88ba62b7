"""The port's single-process clustering service against the reference.

Everything runs on the CPU (``device="cpu"``): the kernel lane's wrappers
take their plain versions there.  Data is made with numpy and handed to
both packages.  DBSCAN labels must equal the sequential oracle and the
reference executor's; K-Means through the port's ``cuda-kernel`` paradigm
must give the reference ``pallas-kernel`` paradigm's labels and iteration
count from the same initial centroids, with inertia and centroids within
1e-5.

The second half runs the reference's ``tests/test_service.py`` cases that
the first half does not cover (admission fairness and bounds, batcher
coalescing and flushing, the cache, the dispatch cost model, metrics, the
core's resumable DBSCAN and masked Lloyd step, the job store, the stale
heartbeat and SIGKILL resume paths), against the port on the CPU.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import kmeans as jax_kmeans
from repro.service import (
    AdmissionQueue as JaxQueue,
    BatchExecutor as JaxExecutor,
    MicroBatcher as JaxBatcher,
    content_key as jax_content_key,
)
from repro.service.dispatch import ItemView as JaxItemView, JaxParadigm
from repro.service.metrics import (
    ServiceMetrics as JaxServiceMetrics,
    percentile as jax_percentile,
)
from repro.service.queue import MiningRequest as JaxRequest
from repro_torch.core import dbscan, kmeans
from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.core.jobs import JobState, JobStore
from repro_torch.kernels import _build
from repro_torch.service import (
    AdmissionQueue,
    BacklogFull,
    BatchExecutor,
    ClusteringService,
    JobSuspended,
    MicroBatcher,
    MiningClient,
    MiningRequest,
    ParadigmRegistry,
    ResultCache,
    TorchParadigm,
    content_key,
    default_registry,
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
from repro_torch.service.executor import SERVICE_JOB_KIND
from repro_torch.service.metrics import ServiceMetrics, percentile

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


# -- the reference's test_service.py cases -------------------------------------


def req(tenant="t0", algo="dbscan", data=None, params=None, executor=None):
    if data is None:
        data = blob(0)
    if params is None:
        params = dict(DB_PARAMS) if algo == "dbscan" else {"k": 4}
    return MiningRequest(tenant=tenant, algo=algo, data=data,
                         params=dict(params), executor=executor)


def test_queue_round_robin_fairness():
    q = AdmissionQueue()
    for _ in range(6):
        q.submit(req(tenant="chatty"))
    q.submit(req(tenant="quiet"))
    drained = q.drain()
    # the quiet tenant's single request must ride in the first rotation
    assert [r.tenant for r in drained[:2]].count("quiet") == 1
    assert len(drained) == 7


def test_queue_backlog_bounds():
    q = AdmissionQueue(max_backlog=4, max_per_tenant=2)
    q.submit(req(tenant="a"))
    q.submit(req(tenant="a"))
    with pytest.raises(BacklogFull):   # per-tenant bound
        q.submit(req(tenant="a"))
    q.submit(req(tenant="b"))
    q.submit(req(tenant="c"))
    with pytest.raises(BacklogFull):   # global bound
        q.submit(req(tenant="d"))
    assert q.rejected == 2


@pytest.mark.parametrize("algo,params", [
    ("apriori", None),
    ("kmeans", {"k": 999}),            # k > n
    ("dbscan", {"eps": 1.0}),          # missing min_pts
])
def test_queue_validates_requests(algo, params):
    with pytest.raises(ValueError):
        AdmissionQueue().submit(req(algo=algo, params=params or {}))


def test_batcher_coalesces_compatible_requests():
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=4, max_wait_s=0.0)
    for tenant in ("a", "b", "c"):
        q.submit(req(tenant=tenant, data=blob(1, points=16)))
    q.submit(req(tenant="a", params={"eps": 0.5, "min_pts": 3}))  # other key
    batches = b.poll()
    assert sorted(batch.size for batch in batches) == [1, 3]
    big = max(batches, key=lambda batch: batch.size)
    assert {r.tenant for r in big.requests} == {"a", "b", "c"}
    assert big.occupancy == 3 / 4
    assert big.n_max >= max(r.n_points for r in big.requests)
    assert big.n_max & (big.n_max - 1) == 0   # pow2 bucket


def test_batcher_full_batch_flushes_immediately():
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=2, max_wait_s=60.0)
    for i in range(5):
        q.submit(req(tenant=f"t{i}", data=blob(2, points=8)))
    batches = b.poll()
    assert sorted(batch.size for batch in batches) == [2, 2]  # 1 staged
    assert b.pending() == 1


def test_batcher_deadline_flush():
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=8, max_wait_s=0.05)
    q.submit(req())
    now = time.time()
    assert b.poll(now=now) == []              # not ripe yet
    assert b.pending() == 1
    batches = b.poll(now=now + 0.06)          # deadline passed
    assert len(batches) == 1 and batches[0].size == 1


def test_batcher_executor_override_splits_key():
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=4, max_wait_s=0.0)
    q.submit(req(executor=EXECUTOR_TORCH_REF))
    q.submit(req(executor=EXECUTOR_CUDA))
    q.submit(req())
    assert len(b.poll()) == 3


def test_cache_returns_isolated_copies():
    c = ResultCache()
    c.put("k", {"labels": np.array([1, 2, 3], np.int16)})
    first = c.get("k")
    first["labels"][0] = 99   # a tenant mutating its copy
    assert c.get("k")["labels"][0] == 1


def test_cache_content_addressing_and_lru():
    c = ResultCache(max_entries=2)
    x1, x2 = blob(1), blob(2)
    k1 = content_key("dbscan", DB_PARAMS, x1)
    assert content_key("dbscan", DB_PARAMS, x1) == k1       # deterministic
    assert content_key("dbscan", DB_PARAMS, x2) != k1       # data-sensitive
    assert content_key("kmeans", {"k": 4}, x1) != k1        # algo-sensitive
    # kmeans seed is per-item (not in the batch key) but must split keys
    assert (content_key("kmeans", {"k": 4, "seed": 1}, x1)
            != content_key("kmeans", {"k": 4, "seed": 2}, x1))
    # the same content hashes as in the reference (fleet placement and
    # the failover tests key labels by it)
    assert k1 == jax_content_key("dbscan", DB_PARAMS, x1)
    c.put(k1, {"labels": np.ones(3)})
    assert c.get(k1)["labels"].sum() == 3
    c.put("k2", {"v": 1})
    c.put("k3", {"v": 2})   # evicts k1 (LRU)
    assert c.get(k1) is None
    assert c.stats()["entries"] == 2


def test_dispatch_cost_model_and_override():
    reg = default_registry(device="cpu")
    # tiny work: host threads win (launch overhead dominates)
    assert reg.select("dbscan", n=64, d=2, batch_size=1,
                      params=DB_PARAMS) == EXECUTOR_NUMPY_MT
    # big work: a device lane
    big = reg.select("dbscan", n=4096, d=4, batch_size=8, params=DB_PARAMS)
    assert big in (EXECUTOR_TORCH_REF, EXECUTOR_CUDA)
    # explicit override always wins and is validated
    assert reg.select("kmeans", n=8, d=2, batch_size=1, params={"k": 2},
                      explicit=EXECUTOR_CUDA) == EXECUTOR_CUDA
    for unknown in ("cuda", "pallas-kernel"):
        with pytest.raises(KeyError):
            reg.select("kmeans", n=8, d=2, batch_size=1, params={"k": 2},
                       explicit=unknown)


def test_metrics_percentiles_and_occupancy():
    cases = [([], 50), ([1.0, 2.0, 3.0, 4.0], 50), ([1.0, 2.0, 3.0, 4.0], 99),
             ([1.0, 2.0], 50), ([5.0], 99)]
    # nearest-rank, no round-half-up; the reference's values
    assert [percentile(v, q) for v, q in cases] == [0.0, 2.0, 4.0, 1.0, 5.0]
    assert [percentile(v, q) for v, q in cases] == [
        jax_percentile(v, q) for v, q in cases]
    snaps = []
    for cls, lane in ((ServiceMetrics, EXECUTOR_TORCH_REF),
                      (JaxServiceMetrics, "jax-ref")):
        m = cls()
        m.record_batch(algo="dbscan", executor=lane, size=3, capacity=4,
                       n_max=64, exec_s=2.0)
        m.record_request(tenant="a", algo="dbscan", executor=lane,
                         latency_s=0.5)
        snaps.append(m.snapshot())
    snap = snaps[0]
    assert snap["mean_occupancy"] == 0.75
    assert snap["modeled_joules"] == pytest.approx(15.0)  # big: 7.5 W x 2 s
    assert snap["by_executor"][EXECUTOR_TORCH_REF]["p50_latency_s"] == 0.5
    for key in ("mean_occupancy", "modeled_joules", "p50_latency_s",
                "p99_latency_s"):
        assert snap[key] == snaps[1][key], key


def test_pack_state_overflow_raises():
    n = 4
    ok = torch.full((n,), dbscan.MAX_CLUSTER_ID, dtype=torch.int32)
    flags = torch.zeros((n,), dtype=torch.bool)
    word = dbscan.pack_state(ok, flags, flags, flags)
    assert int(dbscan.finish(word)[0]) == dbscan.MAX_CLUSTER_ID
    bad = torch.full((n,), dbscan.MAX_CLUSTER_ID + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int16 state word"):
        dbscan.pack_state(bad, flags, flags, flags)


def test_dbscan_resumable_continues_exactly():
    x = torch.from_numpy(blob(5, clusters=8, points=64))
    cfg = dbscan.DBSCANConfig(eps=DB_CFG.eps, min_pts=DB_CFG.min_pts,
                              use_kernel=False)
    full = dbscan.fit_cancellable(x, cfg)
    token = CancellationToken()
    seen = []

    def progress(cid, nexp):
        seen.append(nexp)
        if nexp == 3:
            token.cancel()

    partial, state = dbscan.fit_resumable(x, cfg, token, on_progress=progress)
    assert partial.cancelled and state is not None
    assert state.nexp == 3
    # round-trip through the checkpointable tree form
    state = dbscan.DBSCANRunState.from_tree(state.as_tree())
    resumed, state2 = dbscan.fit_resumable(x, cfg, state=state)
    assert state2 is None and not resumed.cancelled
    assert torch.equal(resumed.labels, full.labels)
    assert int(resumed.expansions) == int(full.expansions)
    np.testing.assert_array_equal(resumed.labels.numpy(),
                                  dbscan.fit_oracle(x.numpy(), cfg))


def test_masked_kmeans_step_ignores_padding():
    xn = blob(6, clusters=3, points=32)
    x = torch.from_numpy(xn)
    cfg = kmeans.KMeansConfig(k=3, use_kernel=False)
    c0 = kmeans.init_centroids(1, x, cfg)
    x_pad = torch.cat([x, torch.zeros((24, x.shape[1]))])
    mask = torch.arange(x_pad.shape[0]) < x.shape[0]
    a_ref, c_ref, _, inertia_ref = kmeans.kmeans_step(x, c0, cfg)
    a, c, _, inertia = kmeans.masked_kmeans_step(x_pad, c0, mask, cfg)
    np.testing.assert_allclose(c.numpy(), c_ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(inertia), float(inertia_ref), rtol=1e-5)
    assert torch.equal(a[: x.shape[0]], a_ref)
    # the reference's masked step from the same centroids
    ja, jc, _, jinertia = jax_kmeans.masked_kmeans_step(
        np.concatenate([xn, np.zeros((24, 2), np.float32)]), c0.numpy(),
        mask.numpy(), jax_kmeans.KMeansConfig(k=3, use_kernel=False))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(inertia), float(jinertia), rtol=1e-5)


def test_jobstore_claim_specific(tmp_path):
    store = JobStore(str(tmp_path / "jobs.db"))
    j1 = store.enqueue("a", {})
    j2 = store.enqueue("b", {})
    job = store.claim(j2)
    assert job.job_id == j2 and job.state == JobState.RUNNING
    assert store.claim(j2) is None          # not claimable while RUNNING
    assert store.get(j1).state == JobState.ENQUEUED
    # a second launcher sharing the db on disk cannot double-claim
    other = JobStore(str(tmp_path / "jobs.db"))
    assert other.claim(j2) is None
    assert other.claim(j1).job_id == j1
    assert store.claim(j1) is None


def _make_batch(requests, max_batch=4):
    return _one_batch(AdmissionQueue, MicroBatcher, requests, max_batch)


@pytest.mark.parametrize("executor", [EXECUTOR_TORCH_REF, EXECUTOR_NUMPY_MT])
def test_batch_kmeans_matches_core_per_executor(tmp_path, executor):
    data = blob(7, clusters=4, points=48)
    batch = _make_batch([req(algo="kmeans", data=data,
                             params={"k": 4, "seed": 3},
                             executor=executor)])
    out = BatchExecutor(str(tmp_path), device="cpu").run_batch(batch)
    assert not out.suspended
    r = out.results[0]
    ref = kmeans.fit_cancellable(3, torch.from_numpy(data),
                                 kmeans.KMeansConfig(k=4, use_kernel=False))
    assert r["converged"] and bool(ref.converged)
    assert r["inertia"] == pytest.approx(float(ref.inertia), rel=1e-4)
    np.testing.assert_array_equal(r["labels"], ref.labels.numpy())


def test_submit_rejects_unhashable_params(tmp_path):
    """Unhashable param values must bounce at the door — inside the worker
    they would kill the serving loop while forming the batch key."""
    with ClusteringService(str(tmp_path), device="cpu") as svc:
        client = MiningClient(service=svc)
        with pytest.raises(ValueError, match="hashable"):
            client.submit("t", "kmeans", blob(1),
                          params={"k": 4, "weights": [1, 2]})


@pytest.mark.parametrize("executor", [EXECUTOR_TORCH_REF, EXECUTOR_CUDA])
def test_dbscan_padding_with_min_pts_one_has_no_phantom_clusters(
        tmp_path, executor):
    """min_pts=1 makes every real point core; isolated pad rows must not
    seed phantom singleton clusters (they'd skew ids and can overflow)."""
    d1, d2 = blob(1, points=16), blob(2, points=8)   # unequal -> padding
    params = {"eps": DB_CFG.eps, "min_pts": 1}
    batch = _make_batch([
        req(data=d1, params=params, executor=executor),
        req(tenant="u", data=d2, params=params, executor=executor),
    ])
    out = BatchExecutor(str(tmp_path), device="cpu").run_batch(batch)
    cfg1 = dbscan.DBSCANConfig(eps=DB_CFG.eps, min_pts=1)
    for d, r in zip((d1, d2), out.results):
        oracle = dbscan.fit_oracle(d, cfg1)
        np.testing.assert_array_equal(r["labels"], oracle)
        assert r["n_clusters"] == int(oracle.max(initial=0))


def test_crash_with_stale_heartbeat_resumes_from_checkpoint(tmp_path):
    """A batch left RUNNING by a dead/stale owner is swept to SUSPENDED on
    restart and resumes from its checkpoint (core/jobs + checkpoint/store)."""
    data = blob(50, clusters=8, points=64)
    oracle = dbscan.fit_oracle(data, DB_CFG)
    batch = _make_batch([req(data=data, executor=EXECUTOR_TORCH_REF)])
    ex = BatchExecutor(str(tmp_path), checkpoint_every=1,
                       heartbeat_timeout=0.05, device="cpu")
    token = CancellationToken()
    ex.run_batch(batch, token=token,
                 progress_hook=lambda j, i, e: e == 2 and token.cancel())
    jid = batch.requests[0].job_id
    # simulate a hard crash: the job looks RUNNING, heartbeat goes stale
    ex.jobs.claim(jid)
    time.sleep(0.1)
    ex2 = BatchExecutor(str(tmp_path), heartbeat_timeout=0.05, device="cpu")
    outcomes = ex2.resume_suspended()
    assert len(outcomes) == 1
    np.testing.assert_array_equal(outcomes[0].results[0]["labels"], oracle)
    assert ex2.jobs.get(jid).state == JobState.SUCCEEDED


def test_service_level_preempt_raises_job_suspended(tmp_path):
    svc = ClusteringService(str(tmp_path), max_batch=1, max_wait_s=0.0,
                            checkpoint_every=1, device="cpu").start()
    h = MiningClient(service=svc).submit(
        "t0", "dbscan", blob(61, clusters=8, points=128), params=DB_PARAMS,
        executor=EXECUTOR_TORCH_REF)
    deadline = time.time() + 30
    while h.job_id is None and time.time() < deadline:
        time.sleep(0.005)   # wait until the batch is durable (job formed)
    svc.stop(preempt=True)
    try:
        h.result(1)
        finished_early = True
    except JobSuspended as e:
        finished_early = False
        assert e.job_id == h.job_id
    svc2 = ClusteringService(str(tmp_path), device="cpu")
    outcomes = svc2.resume_suspended()
    if finished_early:               # tiny machines may outrun the preempt
        assert outcomes == []
    else:
        assert len(outcomes) == 1 and not outcomes[0].suspended
    assert svc2.metrics_snapshot()["resumed_batches"] == len(outcomes)


_KILL_SCRIPT = r"""
import sys, time
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.service import AdmissionQueue, MicroBatcher, BatchExecutor
from repro_torch.service.queue import MiningRequest
from repro_torch.core import dbscan

cfg = dbscan.DBSCANConfig.paper_defaults(2)
x = np.load({data!r})
q = AdmissionQueue(); b = MicroBatcher(q, max_batch=2, max_wait_s=0.0)
q.submit(MiningRequest(tenant="t", algo="dbscan", data=x,
                       params={{"eps": cfg.eps, "min_pts": cfg.min_pts}},
                       executor="torch-ref"))
(batch,) = b.poll()
ex = BatchExecutor({workdir!r}, checkpoint_every=1, device="cpu")
# throttle so the parent reliably lands SIGKILL mid-batch
ex.run_batch(batch, progress_hook=lambda j, i, e: (print("EVT", e, flush=True),
                                                   time.sleep(0.25)))
print("FINISHED", flush=True)
"""


def test_sigkill_subprocess_then_resume(tmp_path):
    """A real kill -9 mid-batch: the restarted executor sweeps the orphaned
    RUNNING job to SUSPENDED and completes it from the periodic checkpoint.
    The child imports the port only."""
    src = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    x = blob(77, clusters=8, points=64)
    np.save(tmp_path / "x.npy", x)
    workdir = str(tmp_path / "svc")
    script = _KILL_SCRIPT.format(src=src, workdir=workdir,
                                 data=str(tmp_path / "x.npy"))
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, text=True)
    saw_events = 0
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("EVT"):
                saw_events += 1
                if saw_events >= 2:   # >= 1 durable post-progress checkpoint
                    break
            if line.startswith("FINISHED") or not line:
                break
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(30)

    # the child sleeps 0.25 s an event: it cannot finish before the kill
    assert saw_events >= 2, "child finished before the kill landed"
    oracle = dbscan.fit_oracle(x, DB_CFG)
    ex = BatchExecutor(workdir, device="cpu")
    jobs = ex.jobs.list_jobs(JobState.RUNNING)
    assert len(jobs) == 1 and jobs[0].kind == SERVICE_JOB_KIND
    outcomes = ex.resume_suspended()
    assert len(outcomes) == 1 and not outcomes[0].suspended
    np.testing.assert_array_equal(outcomes[0].results[0]["labels"], oracle)
