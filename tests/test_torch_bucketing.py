"""The reference's bucketing tests (``tests/test_bucketing.py``) against the
port: the policy zoo (pow2/linear/adaptive), adaptive re-fit under drift,
plan costs pricing the padded (not raw) shape, the metrics ``bucketing``
block, and the WAL's cross-process single-writer lock (its probe process
imports ``repro_torch`` only).  Everything runs with ``device="cpu"``.

Cross-package cases feed the same sizes to both packages' policies, cost
model and metrics and require equal answers.
"""

import subprocess
import sys
import threading

import numpy as np
import pytest

from repro.service import (
    AdaptivePolicy as JaxAdaptivePolicy,
    LinearPolicy as JaxLinearPolicy,
    Pow2Policy as JaxPow2Policy,
)
from repro.service.dispatch import (
    estimate_item_bytes as jax_estimate_item_bytes,
    estimate_work as jax_estimate_work,
)
from repro.service.metrics import ServiceMetrics as JaxServiceMetrics
from repro_torch.service import (
    AdaptivePolicy,
    AdmissionQueue,
    BatchExecutor,
    ClusteringService,
    LinearPolicy,
    MicroBatcher,
    MiningClient,
    MiningRequest,
    Pow2Policy,
    RequestLog,
    default_registry,
    make_policy,
)
from repro_torch.service.bucketing import pow2_bucket
from repro_torch.service.dispatch import (
    EXECUTOR_DISTRIBUTED,
    EXECUTOR_NUMPY_MT,
    estimate_item_bytes,
    estimate_work,
)
from repro_torch.service.metrics import ServiceMetrics

SRC = __file__.rsplit("/tests/", 1)[0] + "/src"


def req(n_points, tenant="t0", algo="kmeans", params=None, features=2):
    rng = np.random.default_rng(n_points)
    data = rng.normal(size=(n_points, features)).astype(np.float32)
    return MiningRequest(tenant=tenant, algo=algo, data=data,
                         params=dict(params or {"k": 2, "seed": 0}))


# -- policy boundaries ---------------------------------------------------------


@pytest.mark.parametrize("policy,cases", [
    (Pow2Policy(), [(1, 8), (8, 8), (9, 16), (256, 256), (257, 512)]),
    (LinearPolicy(100), [(1, 100), (100, 100), (101, 200)]),
], ids=["pow2", "linear"])
def test_policy_boundaries(policy, cases):
    # never below the minimum; an exact edge maps to itself
    for n, bucket in cases:
        assert policy.bucket(n) == bucket, (policy.name, n)


def test_linear_policy_rejects_zero_step():
    with pytest.raises(ValueError):
        LinearPolicy(0)


def test_all_policies_cover_and_idempotent():
    fitted = AdaptivePolicy(4, refit_every=8)
    for _ in range(16):
        fitted.observe(100)
        fitted.observe(700)
    for p in (Pow2Policy(), LinearPolicy(64), AdaptivePolicy(), fitted):
        for n in (1, 7, 8, 63, 64, 100, 101, 700, 999, 4097):
            b = p.bucket(n)
            assert b >= n and b >= 8, (p.name, n)
            assert p.bucket(b) == b, (p.name, n)   # idempotent


def test_make_policy_specs():
    assert isinstance(make_policy(None), Pow2Policy)
    assert isinstance(make_policy("pow2"), Pow2Policy)
    assert make_policy("linear:128").step == 128
    a = make_policy("adaptive:12:32")
    assert a.max_buckets == 12 and a.refit_every == 32
    p = Pow2Policy()
    assert make_policy(p) is p                     # instance passthrough
    for bad in ("nope", "linear:x", "adaptive:1:2:3", "pow2:8"):
        with pytest.raises(ValueError):
            make_policy(bad)


@pytest.mark.parametrize("make", [
    lambda pkg: pkg["pow2"](),
    lambda pkg: pkg["linear"](64),
    lambda pkg: pkg["adaptive"](4, refit_every=8),
], ids=["pow2", "linear", "adaptive"])
def test_policies_bucket_like_the_reference(make):
    """The same observed sizes give the same edges and buckets in both
    packages (the policy is copied verbatim)."""
    port = make({"pow2": Pow2Policy, "linear": LinearPolicy,
                 "adaptive": AdaptivePolicy})
    ref = make({"pow2": JaxPow2Policy, "linear": JaxLinearPolicy,
                "adaptive": JaxAdaptivePolicy})
    rng = np.random.default_rng(11)
    for n in rng.integers(1, 5000, size=200):
        port.observe(int(n))
        ref.observe(int(n))
        assert port.bucket(int(n)) == ref.bucket(int(n)), int(n)
        assert port.bucket_ceiling(int(n)) == ref.bucket_ceiling(int(n))
    assert port.snapshot() == ref.snapshot()


# -- adaptive fitting ----------------------------------------------------------


def test_adaptive_unfitted_falls_back_to_pow2():
    a = AdaptivePolicy()
    for n in (1, 100, 300, 5000):
        assert a.bucket(n) == pow2_bucket(n)


def test_adaptive_fits_tight_edges_and_bounds_cardinality():
    a = AdaptivePolicy(4, refit_every=16)
    for _ in range(20):
        a.observe(100)
        a.observe(700)
    assert a.fitted and a.refits >= 1
    assert len(a.edges()) <= 4
    # fitted edges hug the observed sizes (aligned up to 8)
    assert a.bucket(100) == 104
    assert a.bucket(700) == 704
    # far outliers past the largest edge stay on the pow2 fallback
    assert a.bucket(10_000) == pow2_bucket(10_000)
    snap = a.snapshot()
    assert snap["edges"] == a.edges() and snap["refits"] == a.refits


def test_adaptive_refits_under_drift():
    """When the shape distribution moves, the edges follow it within a
    few refit periods and the old regime decays out of the histogram."""
    a = AdaptivePolicy(2, refit_every=10, decay=0.2)
    for _ in range(30):
        a.observe(100)
    assert a.bucket(100) == 104
    assert a.bucket(300) == pow2_bucket(300)       # not yet seen
    for _ in range(120):
        a.observe(300)
    assert a.bucket(300) == 304                    # tightened from 512
    assert len(a.edges()) <= 2
    # the abandoned size eventually leaves the fitted edge set entirely
    assert a.edges() == [304]


def test_adaptive_beats_pow2_on_skew_at_equal_budget():
    rng = np.random.default_rng(3)
    sizes = np.clip(16 * rng.zipf(1.3, size=300), 16, 2048).astype(int)
    budget = len({pow2_bucket(int(s)) for s in sizes})
    a = AdaptivePolicy(budget)
    for s in sizes:
        a.observe(int(s))
    a.refit()
    waste_pow2 = 1 - sizes.sum() / sum(pow2_bucket(int(s)) for s in sizes)
    waste_a = 1 - sizes.sum() / sum(a.bucket(int(s)) for s in sizes)
    assert waste_a < waste_pow2
    assert len({a.bucket(int(s)) for s in sizes}) <= budget


def test_adaptive_observe_is_thread_safe():
    a = AdaptivePolicy(4, refit_every=5)
    errors = []

    def feed(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(200):
                a.observe(int(rng.integers(8, 1000)))
                a.bucket(int(rng.integers(8, 5000)))
        except Exception as e:                     # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=feed, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors and a.observed == 800


def test_adaptive_bucket_clamped_at_pow2():
    """A request far below its covering edge (the shape mix drifted large)
    must never pad more than the fixed pow2 policy would."""
    a = AdaptivePolicy(2, refit_every=8)
    for _ in range(16):
        a.observe(1500)
    assert a.edges() == [1504]
    # n=600: covering edge is 1504 but pow2 is 1024 — clamp wins
    assert a.bucket(600) == 1024
    assert a.bucket(1200) == 1504          # within pow2(1200)=2048: edge wins


def test_bucket_ceiling_bounds_bucket_for_all_policies():
    drifting = AdaptivePolicy(4, refit_every=4)
    policies = [Pow2Policy(), LinearPolicy(200), drifting]
    rng = np.random.default_rng(9)
    for _ in range(50):
        n = int(rng.integers(1, 3000))
        for p in policies:
            assert p.bucket(n) <= p.bucket_ceiling(n), (p.name, n)
        drifting.observe(int(rng.integers(1, 3000)))  # keep edges moving


# -- the batcher pads through the policy ---------------------------------------


def test_batcher_uses_policy_bucket():
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=4, max_wait_s=0.0,
                     bucket_policy=LinearPolicy(50))
    for t in ("a", "b"):
        q.submit(req(60, tenant=t))
    (batch,) = b.poll()
    assert batch.n_max == 100                      # not pow2's 64
    assert batch.n_pad == 100


def test_batcher_defaults_to_pow2():
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=4, max_wait_s=0.0)
    q.submit(req(60))
    (batch,) = b.poll()
    assert batch.n_max == 64


def test_batcher_survives_poisoned_policy():
    class Bad(Pow2Policy):
        def bucket(self, n):
            raise RuntimeError("boom")

        def observe(self, n):
            raise RuntimeError("boom")

    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=4, max_wait_s=0.0, bucket_policy=Bad())
    q.submit(req(60))
    (batch,) = b.poll()                            # work still flows
    assert batch.n_max == 64                       # pow2 fallback


# -- plans price the padded shape ----------------------------------------------


def test_plan_prices_policy_bucket_not_raw_shape(tmp_path):
    """The executed batch pads every item to the policy bucket, so the
    plan's n_max/cost must be the bucket, not the raw max point count."""
    q = AdmissionQueue()
    batcher = MicroBatcher(q, max_batch=2, max_wait_s=0.0,
                           bucket_policy=LinearPolicy(100))
    q.submit(req(60))
    (batch,) = batcher.poll()
    ex = BatchExecutor(str(tmp_path), registry=default_registry(device="cpu"))
    outcome = ex.run_batch(batch, executor=EXECUTOR_NUMPY_MT)
    assert outcome.plan["n_max"] == 100
    assert outcome.plan["cost"] == pytest.approx(estimate_work(
        "kmeans", 100, 2, 1, {"k": 2}))
    assert outcome.lengths == [60]


@pytest.mark.parametrize("algo,params", [
    ("kmeans", {"k": 4}), ("kmeans", {"k": 64}),
    ("dbscan", {"eps": 0.3, "min_pts": 4}),
])
def test_cost_model_matches_the_reference(algo, params):
    """The dispatch cost model and the per-item byte estimate (the budget
    input) price every shape as the reference's do."""
    for n, d, b in ((64, 2, 1), (640, 2, 4), (1024, 4, 8), (65536, 32, 2)):
        assert estimate_work(algo, n, d, b, params) == pytest.approx(
            jax_estimate_work(algo, n, d, b, params), rel=1e-12)
        assert estimate_item_bytes(algo, n, d, params) == pytest.approx(
            jax_estimate_item_bytes(algo, n, d, params), rel=1e-12)


def test_oversized_judged_at_policy_bucket():
    reg = default_registry(device_budget_bytes=64 * 1024, device="cpu")
    # kmeans n=1000: pow2 buckets to 1024 (~49 KiB, under budget); a
    # coarse linear policy pads to 2000 (~95 KiB, over) — the budget must
    # follow the shape the request will actually run at
    assert not reg.oversized("kmeans", 1000, 2, {"k": 4})
    coarse = LinearPolicy(2000)
    assert reg.oversized("kmeans", 1000, 2, {"k": 4}, bucket=coarse.bucket)


def test_run_batch_select_prices_final_bucket_verbatim(tmp_path):
    """run_batch's cost-model path must not re-round an already-padded
    n_max up another pow2 window: a batch bucketed to 640 under a budget
    that fits 640 but not 1024 stays on a single-device lane."""
    budget = (estimate_item_bytes("dbscan", 640, 2, {}) +
              estimate_item_bytes("dbscan", 1024, 2, {})) / 2
    reg = default_registry(device_budget_bytes=budget, device="cpu")
    q = AdmissionQueue()
    batcher = MicroBatcher(q, max_batch=2, max_wait_s=0.0,
                           bucket_policy=LinearPolicy(640))
    q.submit(req(600, algo="dbscan",
                 params={"eps": 0.3, "min_pts": 4}))
    (batch,) = batcher.poll()
    assert batch.n_max == 640
    ex = BatchExecutor(str(tmp_path), registry=reg)
    outcome = ex.run_batch(batch)          # no pinned executor: cost model
    assert outcome.executor != EXECUTOR_DISTRIBUTED
    assert outcome.plan["n_max"] == 640


# -- metrics -------------------------------------------------------------------


def _record_three(m):
    m.record_batch(algo="kmeans", executor="numpy-mt", size=4, capacity=4,
                   n_max=128, exec_s=0.1, real_points=300, features=2)
    m.record_batch(algo="kmeans", executor="numpy-mt", size=2, capacity=4,
                   n_max=128, exec_s=0.1, real_points=200, features=2)
    m.record_batch(algo="kmeans", executor="numpy-mt", size=1, capacity=4,
                   n_max=256, exec_s=0.1, real_points=250, features=2)
    return m.snapshot()["bucketing"]


def test_metrics_bucketing_counters():
    b = _record_three(ServiceMetrics())
    assert b["real_points"] == 750
    assert b["padded_points"] == 4 * 128 + 2 * 128 + 1 * 256
    assert b["point_occupancy"] == pytest.approx(750 / 1024)
    assert b["padding_waste"] == pytest.approx(1 - 750 / 1024)
    # recompiles count distinct compiled shapes, not batches
    assert b["recompiles"] == 2
    assert b["by_bucket"] == {"128": 2, "256": 1}
    # the same batches give the reference's block
    assert b == _record_three(JaxServiceMetrics())


def test_service_snapshot_carries_policy_state(tmp_path):
    svc = ClusteringService(str(tmp_path), max_batch=2, max_wait_s=0.002,
                            bucket_policy="linear:50", cache_entries=0,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc:
        hs = [client.submit(f"t{i}", "kmeans", req(30 + 9 * i).data,
                            params={"k": 2, "seed": 0},
                            executor=EXECUTOR_NUMPY_MT)
              for i in range(4)]
        for h in hs:
            h.result(120)
    b = svc.metrics_snapshot()["bucketing"]
    assert b["policy"]["name"] == "linear:50"
    assert b["real_points"] > 0
    assert b["padded_points"] >= b["real_points"]
    assert b["recompiles"] >= 1
    assert all(int(k) % 50 == 0 for k in b["by_bucket"])


def test_service_default_policy_is_adaptive(tmp_path):
    svc = ClusteringService(str(tmp_path), device="cpu")
    assert isinstance(svc.bucket_policy, AdaptivePolicy)
    # cold adaptive == the historical pow2 behaviour
    assert svc.bucket_policy.bucket(60) == 64
    svc.wal.close()


# -- WAL single-writer lock ----------------------------------------------------


def _probe(root, detail=False):
    """A process that imports the port only and tries to open the WAL."""
    check = ("    assert e.root and e.holder_pid, (e.root, e.holder_pid)\n"
             if detail else "")
    return (
        "import sys\n"
        f"sys.path.insert(0, {SRC!r})\n"
        "from repro_torch.service import RequestLog, WalLocked\n"
        "try:\n"
        f"    RequestLog({root!r})\n"
        "except WalLocked as e:\n"
        f"{check}"
        "    sys.exit(7)\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "sys.exit(0)\n"
    )


def test_wal_lock_excludes_other_processes(tmp_path):
    log = RequestLog(str(tmp_path))
    probe = _probe(str(tmp_path), detail=True)
    out = subprocess.run([sys.executable, "-c", probe], timeout=120)
    assert out.returncode == 7                     # structured rejection
    log.close()                                    # releases the lock
    out = subprocess.run([sys.executable, "-c", probe], timeout=120)
    assert out.returncode == 0


def test_wal_lock_released_on_close_and_reacquired_on_append(tmp_path):
    log = RequestLog(str(tmp_path))
    log.append_admit("t0", "kmeans", np.zeros((4, 2), np.float32), {"k": 2})
    assert log.stats()["locked"]
    log.close()
    assert not log.stats()["locked"]
    # a lazy reopen (append after close) re-takes the lock
    log.append_admit("t0", "kmeans", np.zeros((4, 2), np.float32), {"k": 2})
    assert log.stats()["locked"]
    log.close()


def test_same_process_service_handover_still_works(tmp_path):
    """POSIX record locks are per-process: dropping one service and opening
    the next over the same workdir without a clean stop works in one
    process."""
    wd = str(tmp_path / "svc")
    svc1 = ClusteringService(wd, device="cpu")
    svc2 = ClusteringService(wd, device="cpu")     # no WalLocked
    svc1.wal.close()
    svc2.wal.close()


def test_in_process_close_does_not_drop_siblings_lock(tmp_path):
    """Closing a second in-process log must not release the first log's OS
    lock (the refcounted shared-fd guard)."""
    log1 = RequestLog(str(tmp_path))
    log2 = RequestLog(str(tmp_path))               # same process: shared
    log2.close()                                   # must NOT free the lock
    probe = _probe(str(tmp_path))
    assert subprocess.run([sys.executable, "-c", probe],
                          timeout=120).returncode == 7
    assert log1.stats()["locked"]
    log1.close()                                   # last holder: released
    assert subprocess.run([sys.executable, "-c", probe],
                          timeout=120).returncode == 0
