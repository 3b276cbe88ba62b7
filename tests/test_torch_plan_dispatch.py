"""The port's twins of tests/test_plan_dispatch.py, on the CPU: plan
selection at the device-memory budget boundary, the distributed paradigm
end to end (oversized K-Means and DBSCAN routed with no opt-in, labels
equal to the single-device reference), mid-shard preemption + resume
(preempted on a mesh of 4 or 3 shards and resumed on the host's own
mesh of 1, and the reverse),
token-bucket rate limiting, the energy-EWMA dispatch tie-breaker, and the
result cache's disk spill.

Lanes are renamed (``pallas-kernel`` is ``cuda-kernel``, ``jax-ref`` is
``torch-ref``); inputs are made with numpy; every paradigm runs on the CPU
(``device="cpu"``), where the kernel wrappers take their plain versions.
The sleep-timed cases give their deadlines more margin than the
reference's (a loaded test machine).
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import dbscan, distributed as dist, kmeans
from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.core.jobs import JobState
from repro_torch.service import (
    EXECUTOR_CUDA,
    EXECUTOR_DISTRIBUTED,
    EXECUTOR_NUMPY_MT,
    EXECUTOR_TORCH_REF,
    AdmissionQueue,
    BacklogFull,
    BatchExecutor,
    ClusteringService,
    DistributedParadigm,
    ExecutionPlan,
    MicroBatcher,
    MiningClient,
    MiningRequest,
    ParadigmRegistry,
    RateLimited,
    RequestTooLarge,
    ResultCache,
    default_registry,
)
from repro_torch.service.dispatch import NumpyMTParadigm, estimate_item_bytes
from repro_torch.service.energy import BIG
from repro_torch.service.metrics import HINT_STALENESS_DECAY, ServiceMetrics

DB_CFG = dbscan.DBSCANConfig.paper_defaults(2)
DB_PARAMS = {"eps": DB_CFG.eps, "min_pts": DB_CFG.min_pts}
SMALL_BUDGET = 64 * 1024   # bytes — makes modest test requests "oversized"
CPU = torch.device("cpu")


def registry(budget=SMALL_BUDGET, shards=None):
    """The default registry on the CPU; ``shards`` gives its distributed
    lane a mesh that repeats the host that many times."""
    reg = default_registry(device_budget_bytes=budget, device="cpu")
    if shards is not None:
        reg.register(DistributedParadigm(
            device="cpu", mesh=dist.Mesh((CPU,) * shards)))
    return reg


def blob(seed, clusters=4, points=32, features=2, spread=0.5):
    """Gaussian blobs made with numpy (the reference draws its own with
    jax.random; these are the same shapes)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(clusters, features))
    x = np.concatenate([c + rng.normal(0.0, spread, size=(points, features))
                        for c in centers]).astype(np.float32)
    rng.shuffle(x)
    return x


def req(tenant="t0", algo="dbscan", data=None, params=None, executor=None):
    if data is None:
        data = blob(0)
    if params is None:
        params = dict(DB_PARAMS) if algo == "dbscan" else {"k": 4}
    return MiningRequest(tenant=tenant, algo=algo, data=data,
                         params=dict(params), executor=executor)


def make_batch(request, registry=None):
    q = AdmissionQueue()
    oversized = None
    if registry is not None:
        oversized = lambda r: registry.oversized(   # noqa: E731
            r.algo, r.n_points, r.features, r.params)
    b = MicroBatcher(q, max_batch=4, max_wait_s=0.0, oversized=oversized)
    q.submit(request)
    (batch,) = b.poll()
    return batch


def kmeans_reference(seed, data, **cfg):
    """The single-device reference: the plain Lloyd loop from the same
    seeding the service's lanes use."""
    return kmeans.fit_cancellable(
        seed, torch.from_numpy(data),
        kmeans.KMeansConfig(k=4, use_kernel=False, **cfg))


# -- the plan phase ------------------------------------------------------------


def test_every_paradigm_plans():
    reg = registry()
    for name in reg.names():
        plan = reg.get(name).plan("kmeans", {"k": 4}, batch_size=2,
                                  n_max=64, features=2)
        assert isinstance(plan, ExecutionPlan)
        assert plan.paradigm == name
        assert plan.cost > 0 and plan.modeled_joules > 0
        assert plan.config is not None
        assert plan.summary()["paradigm"] == name   # JSON-able view


def test_distributed_plan_spans_local_devices():
    reg = registry(budget=None)
    plan = reg.get(EXECUTOR_DISTRIBUTED).plan(
        "kmeans", {"k": 4}, batch_size=1, n_max=4096, features=2)
    assert plan.devices == 1 and plan.shards == 1   # the host's own mesh
    assert plan.shards * plan.shard_rows >= plan.n_max
    # a mesh that repeats the host: 3 shards on 1 device
    plan = registry(shards=3).get(EXECUTOR_DISTRIBUTED).plan(
        "dbscan", DB_PARAMS, batch_size=1, n_max=4096, features=2)
    assert (plan.devices, plan.shards, plan.shard_rows) == (1, 3, 1366)
    assert plan.config.use_kernel   # the lane runs the kernels


def test_energy_hint_scales_plan_joules():
    reg = registry(budget=None)
    p = reg.get(EXECUTOR_TORCH_REF)
    base = p.plan("kmeans", {"k": 4}, batch_size=1, n_max=256, features=2)
    hinted = p.plan("kmeans", {"k": 4}, batch_size=1, n_max=256, features=2,
                    energy_hint=2.0)
    assert hinted.modeled_joules == pytest.approx(2.0 * hinted.cost)
    assert hinted.modeled_joules != base.modeled_joules


# -- budget boundary selection -------------------------------------------------


def test_budget_boundary_picks_distributed():
    reg = registry()
    # small request: host threads still win (launch overhead dominates)
    assert reg.select("kmeans", n=64, d=2, batch_size=1,
                      params={"k": 4}) == EXECUTOR_NUMPY_MT
    # over the per-device budget: exactly one home, no caller opt-in
    assert estimate_item_bytes("kmeans", 4096, 2, {"k": 4}) > SMALL_BUDGET
    assert reg.candidates("kmeans", n=4096, d=2, batch_size=1,
                          params={"k": 4}) == [EXECUTOR_DISTRIBUTED]
    # dbscan's working set is quadratic: a smaller n crosses the budget
    assert reg.candidates("dbscan", n=512, d=2, batch_size=1,
                          params=DB_PARAMS) == [EXECUTOR_DISTRIBUTED]
    # the budget is judged at the pow2 *bucket* the request will be padded
    # to, not the raw n: 100 points pad to 128 and the (128, 128) DBSCAN
    # intermediate is over this budget
    assert reg.oversized("dbscan", 100, 2, DB_PARAMS)
    # under the boundary: the normal accelerated candidates, never the
    # distributed lane (kmeans n=1000 buckets to 1024: ~49 KiB < 64 KiB)
    under = reg.candidates("kmeans", n=1000, d=2, batch_size=32,
                           params={"k": 4})
    assert EXECUTOR_DISTRIBUTED not in under
    assert under[0] in (EXECUTOR_TORCH_REF, EXECUTOR_CUDA)


def test_small_requests_keep_their_paradigms_with_default_budget():
    reg = registry(budget=None)
    assert reg.select("dbscan", n=64, d=2, batch_size=1,
                      params=DB_PARAMS) == EXECUTOR_NUMPY_MT
    big = reg.select("dbscan", n=4096, d=4, batch_size=8, params=DB_PARAMS)
    assert big in (EXECUTOR_TORCH_REF, EXECUTOR_CUDA)


def test_explicit_override_beats_budget():
    reg = registry()
    assert reg.candidates("kmeans", n=4096, d=2, batch_size=1,
                          params={"k": 4},
                          explicit=EXECUTOR_TORCH_REF) == [EXECUTOR_TORCH_REF]


def test_oversized_without_distributed_falls_back():
    reg = ParadigmRegistry(device_budget_bytes=SMALL_BUDGET, device="cpu")
    reg.register(NumpyMTParadigm())
    assert reg.oversized("kmeans", 4096, 2, {"k": 4})
    # no distributed paradigm registered: the old behaviour survives
    assert reg.select("kmeans", n=4096, d=2, batch_size=1,
                      params={"k": 4}) == EXECUTOR_NUMPY_MT


def test_energy_ewma_tiebreaks_accel_candidates():
    reg = registry(budget=None)
    big = dict(algo="dbscan", n=4096, d=4, batch_size=8, params=DB_PARAMS)
    base = reg.candidates(**big)
    assert base[0] == EXECUTOR_TORCH_REF   # the CPU prefers the plain lane
    flipped = reg.candidates(**big, energy_hints={
        EXECUTOR_TORCH_REF: 5.0, EXECUTOR_CUDA: 1.0})
    assert flipped[0] == EXECUTOR_CUDA
    # partial hints (one paradigm never ran): cost-model order stands
    partial = reg.candidates(**big, energy_hints={EXECUTOR_CUDA: 1.0})
    assert partial == base


# -- oversized requests end to end ---------------------------------------------


def test_batcher_bypasses_oversized_into_singleton():
    reg = registry()
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=8, max_wait_s=60.0,
                     oversized=lambda r: reg.oversized(
                         r.algo, r.n_points, r.features, r.params))
    big = req(algo="kmeans", data=blob(1, points=512),
              params={"k": 4, "seed": 1})
    small = req(tenant="t1", algo="kmeans", data=blob(2, points=8),
                params={"k": 4, "seed": 2})
    q.submit(big)
    q.submit(small)
    batches = b.poll()
    # the oversized request must not wait for max_wait_s or batch-mates
    assert len(batches) == 1 and batches[0].oversized
    assert batches[0].size == 1 and batches[0].capacity == 1
    assert batches[0].requests[0] is big
    assert b.pending() == 1              # the small one stages normally


@pytest.mark.parametrize("shards", [None, 3])
def test_oversized_kmeans_matches_single_device_reference(tmp_path, shards):
    reg = registry(shards=shards)
    data = blob(3, clusters=4, points=512)
    batch = make_batch(req(algo="kmeans", data=data,
                           params={"k": 4, "seed": 7, "max_iters": 60}),
                       registry=reg)
    assert batch.oversized
    out = BatchExecutor(str(tmp_path), registry=reg).run_batch(batch)
    assert not out.suspended
    assert out.executor == EXECUTOR_DISTRIBUTED
    assert out.plan["shards"] == (shards or 1)
    ref = kmeans_reference(7, data, max_iters=60)
    r = out.results[0]
    assert (r["labels"] == ref.labels.numpy()).all()
    assert r["iterations"] == int(ref.iterations)


@pytest.mark.parametrize("shards", [None, 4])
def test_oversized_dbscan_matches_oracle(tmp_path, shards):
    reg = registry(shards=shards)
    data = blob(4, clusters=4, points=128)     # n=512: over budget (4n^2)
    batch = make_batch(req(data=data), registry=reg)
    assert batch.oversized
    out = BatchExecutor(str(tmp_path), registry=reg).run_batch(batch)
    assert not out.suspended
    assert out.executor == EXECUTOR_DISTRIBUTED
    oracle = dbscan.fit_oracle(data, DB_CFG)
    r = out.results[0]
    assert (r["labels"] == oracle).all()
    assert r["n_clusters"] == int(oracle.max(initial=0))


@pytest.mark.parametrize("shards_from,shards_to", [(4, None), (3, None),
                                                   (None, 3)])
@pytest.mark.parametrize("algo", ["kmeans", "dbscan"])
def test_oversized_preempt_mid_shard_then_resume(tmp_path, algo, shards_from,
                                                 shards_to):
    """Preempted mid-shard on one mesh (cooperative preemption, what
    PreemptionGuard maps SIGTERM to), restarted, resumed on another (None:
    the host's own mesh of 1; 3 shards pad a 512-row DBSCAN item by a row,
    so its state is resized both ways): labels identical to the
    uninterrupted single-device reference."""
    reg = registry(shards=shards_from)
    if algo == "kmeans":
        # overlapping clusters: enough Lloyd iterations to preempt mid-run
        data = blob(5, clusters=4, points=512, spread=4.0)
        request = req(algo="kmeans", data=data,
                      params={"k": 4, "seed": 11, "max_iters": 200,
                              "tol": 1e-9})
        ref = kmeans_reference(11, data, max_iters=200, tol=1e-9)
        expected = ref.labels.numpy()
    else:
        data = blob(6, clusters=8, points=64)
        request = req(data=data)
        expected = dbscan.fit_oracle(data, DB_CFG)

    batch = make_batch(request, registry=reg)
    assert batch.oversized
    ex = BatchExecutor(str(tmp_path), registry=reg, checkpoint_every=2)
    token = CancellationToken()

    def hook(job_id, item, events):
        if events == 2:   # mid-item, after at least one sharded checkpoint
            token.cancel(CancelReason.PREEMPTION)

    out = ex.run_batch(batch, token=token, progress_hook=hook)
    assert out.suspended
    assert ex.jobs.get(out.job_id).state == JobState.SUSPENDED

    # "restart": a fresh executor (fresh registry) over the same workdir
    ex2 = BatchExecutor(str(tmp_path), registry=registry(shards=shards_to),
                        checkpoint_every=2)
    outcomes = ex2.resume_suspended()
    assert len(outcomes) == 1 and not outcomes[0].suspended
    assert outcomes[0].resumed
    assert outcomes[0].executor == EXECUTOR_DISTRIBUTED
    assert (outcomes[0].results[0]["labels"] == expected).all()
    if algo == "kmeans":
        assert outcomes[0].results[0]["iterations"] == int(ref.iterations)
    assert ex2.jobs.get(out.job_id).state == JobState.SUCCEEDED


def test_service_routes_oversized_with_no_opt_in(tmp_path):
    """Full service path: submit() only — admission, bypass, lane pool,
    durable execution — lands on the distributed paradigm by cost model."""
    data = blob(8, clusters=4, points=512)
    with ClusteringService(str(tmp_path), max_wait_s=0.005,
                           device_budget_bytes=SMALL_BUDGET,
                           device="cpu") as svc:
        client = MiningClient(service=svc)
        h = client.submit("t0", "kmeans", data,
                          params={"k": 4, "seed": 7, "max_iters": 60})
        result = h.result(600)
    assert result["executor"] == EXECUTOR_DISTRIBUTED
    ref = kmeans_reference(7, data, max_iters=60)
    assert (result["labels"] == ref.labels.numpy()).all()
    snap = svc.metrics_snapshot()
    assert snap["by_executor"][EXECUTOR_DISTRIBUTED]["batches"] >= 1


def test_service_without_distributed_bounces_oversized(tmp_path):
    reg = ParadigmRegistry(device_budget_bytes=SMALL_BUDGET, device="cpu")
    reg.register(NumpyMTParadigm())
    with ClusteringService(str(tmp_path), registry=reg,
                           device="cpu") as svc:
        with pytest.raises(RequestTooLarge) as ei:
            svc._submit("t0", "kmeans", blob(9, points=512),
                        params={"k": 4})
        assert ei.value.n_points == 2048
        # small requests are still welcome
        h = svc._submit("t0", "kmeans", blob(9, points=8), params={"k": 4})
        assert h.wait(300)["iterations"] >= 1


# -- token-bucket rate limiting ------------------------------------------------


def test_rate_limit_token_bucket():
    q = AdmissionQueue(tenant_rate=5.0, tenant_burst=2)
    q.submit(req(tenant="a"))
    q.submit(req(tenant="a"))
    with pytest.raises(RateLimited) as ei:
        q.submit(req(tenant="a"))
    err = ei.value
    assert err.tenant == "a" and err.rate == 5.0 and err.burst == 2
    assert 0.0 < err.retry_after <= 0.2 + 1e-6
    assert q.rate_limited == 1
    # other tenants have their own bucket
    q.submit(req(tenant="b"))
    # refill: after retry_after (and a margin) the tenant is admitted again
    time.sleep(err.retry_after + 0.1)
    q.submit(req(tenant="a"))
    assert q.depth("a") == 3


def test_rate_limited_rejection_consumes_no_token():
    q = AdmissionQueue(tenant_rate=0.5, tenant_burst=1)
    q.submit(req(tenant="a"))
    first = None
    for _ in range(5):   # hammering must not push retry_after out
        with pytest.raises(RateLimited) as ei:
            q.submit(req(tenant="a"))
        first = first or ei.value.retry_after
        assert ei.value.retry_after <= first + 1e-6
    assert first <= 2.0 + 1e-6   # exactly one token away at 0.5/s


def test_backlog_rejection_burns_no_token():
    # tenant_rate tiny: no meaningful refill during the test
    q = AdmissionQueue(max_per_tenant=1, tenant_rate=0.001, tenant_burst=5)
    q.submit(req(tenant="a"))                     # 1 token spent
    for _ in range(3):                            # depth bounce, not rate
        with pytest.raises(BacklogFull):
            q.submit(req(tenant="a"))
    assert q.rate_limited == 0
    q.drain()
    for _ in range(4):                            # 4 tokens must remain
        q.submit(req(tenant="a"))
        q.drain()
    with pytest.raises(RateLimited):              # now the bucket is dry
        q.submit(req(tenant="a"))


@pytest.mark.parametrize("shards", [1, 3])
def test_kmeans_resume_at_iteration_ceiling_keeps_labels(shards):
    """A checkpoint written exactly at max_iters carries centroids but no
    labels; resuming from it must recover the assignment, not complete
    with every point in cluster 0."""
    data = blob(14, clusters=4, points=512)
    cfg = kmeans.KMeansConfig(k=4, use_kernel=False, max_iters=8)
    ref = kmeans.fit_cancellable(2, torch.from_numpy(data), cfg)
    mesh = dist.Mesh((CPU,) * shards)
    n_pad = shards * dist.shard_rows(data.shape[0], shards)
    x_pad = np.zeros((n_pad, data.shape[1]), np.float32)
    x_pad[: data.shape[0]] = data
    mask = np.arange(n_pad) < data.shape[0]
    result, mid = dist.sharded_kmeans_fit_resumable(
        mesh, x_pad, mask, cfg,
        centroids=ref.centroids, start_iteration=cfg.max_iters)
    assert mid is None and not result.cancelled
    labels = result.labels[: data.shape[0]].numpy()
    assert len(np.unique(labels)) > 1             # not all-zero
    # the reported labels are the assignment of the checkpointed centroids
    d2 = ((data[:, None, :] - ref.centroids.numpy()[None, :, :]) ** 2).sum(-1)
    assert (labels == d2.argmin(1)).all()


def test_rate_limit_off_by_default():
    q = AdmissionQueue()
    for _ in range(50):
        q.submit(req(tenant="a", data=blob(0, points=4)))
    assert q.rate_limited == 0


# -- energy EWMA ---------------------------------------------------------------


def test_metrics_energy_ewma_feeds_hints():
    m = ServiceMetrics()
    assert m.energy_hints() == {}
    m.record_batch(algo="kmeans", executor=EXECUTOR_TORCH_REF, size=1,
                   capacity=1, n_max=64, exec_s=2.0, work=1e6)
    hints = m.energy_hints()
    # big: 7.5 W x 2 s / work
    assert hints[EXECUTOR_TORCH_REF] == pytest.approx(15.0 / 1e6)
    # EWMA: a second, slower batch moves the estimate toward it, partially
    m.record_batch(algo="kmeans", executor=EXECUTOR_TORCH_REF, size=1,
                   capacity=1, n_max=64, exec_s=4.0, work=1e6)
    updated = m.energy_hints()[EXECUTOR_TORCH_REF]
    assert hints[EXECUTOR_TORCH_REF] < updated < 30.0 / 1e6
    # zero-work batches (no plan) never poison the estimate
    m.record_batch(algo="kmeans", executor=EXECUTOR_NUMPY_MT, size=1,
                   capacity=1, n_max=64, exec_s=1.0)
    assert EXECUTOR_NUMPY_MT not in m.energy_hints()
    # ...but it does age the torch-ref hint by one batch: the snapshot
    # reads it decayed one step toward the big-class static prior
    prior = BIG.joules_per_work
    decayed = prior + (updated - prior) * (1.0 - HINT_STALENESS_DECAY)
    assert m.snapshot()["joules_per_work"][EXECUTOR_TORCH_REF] == \
        pytest.approx(decayed)


# -- result-cache disk spill ---------------------------------------------------


def test_cache_spills_to_disk_and_survives_restart(tmp_path):
    spill = str(tmp_path / "cache")
    c1 = ResultCache(max_entries=8, spill_dir=spill, ttl_s=60.0)
    labels = np.arange(6, dtype=np.int16)
    c1.put("key-a", {"labels": labels, "algo": "kmeans", "inertia": 1.5,
                     "converged": True})
    # "restart": a fresh cache over the same directory starts warm
    c2 = ResultCache(max_entries=8, spill_dir=spill, ttl_s=60.0)
    got = c2.get("key-a")
    assert got is not None
    assert (got["labels"] == labels).all()
    assert got["algo"] == "kmeans" and got["inertia"] == 1.5
    assert got["converged"] is True
    assert c2.stats()["disk_hits"] == 1
    # second get is a pure memory hit
    assert c2.get("key-a") is not None
    assert c2.stats()["disk_hits"] == 1


def test_cache_memory_eviction_keeps_disk_tier(tmp_path):
    c = ResultCache(max_entries=1, spill_dir=str(tmp_path), ttl_s=60.0)
    c.put("k1", {"v": 1})
    c.put("k2", {"v": 2})          # evicts k1 from memory, not from disk
    assert len(c) == 1
    assert c.get("k1") == {"v": 1}  # served from the spill file


def test_cache_ttl_expires_spilled_entries(tmp_path):
    c = ResultCache(max_entries=1, spill_dir=str(tmp_path), ttl_s=0.05)
    c.put("k1", {"v": 1})
    c.put("k2", {"v": 2})          # k1 now only on disk
    time.sleep(0.3)                # six times the TTL
    assert c.get("k1") is None     # expired and lazily unlinked
    assert c.stats()["misses"] == 1


def test_cache_without_spill_dir_unchanged(tmp_path):
    c = ResultCache(max_entries=2)
    c.put("k", {"labels": np.array([1, 2, 3], np.int16)})
    got = c.get("k")
    got["labels"][0] = 99
    assert c.get("k")["labels"][0] == 1
    assert c.stats()["disk_hits"] == 0


def test_service_cache_warm_after_restart(tmp_path):
    """The serving-level contract: a repeated request after a restart is a
    cache hit (no recompute), served from the spilled entry."""
    data = blob(12, clusters=3, points=24)
    with ClusteringService(str(tmp_path), device="cpu") as svc:
        h = svc._submit("t0", "dbscan", data, params=DB_PARAMS)
        first = h.wait(300)
    svc2 = ClusteringService(str(tmp_path), device="cpu").start()
    try:
        h2 = svc2._submit("t9", "dbscan", data, params=DB_PARAMS)
        assert h2.cache_hit
        assert (h2.wait(5)["labels"] == first["labels"]).all()
        assert svc2.cache.stats()["disk_hits"] == 1
    finally:
        svc2.stop()
