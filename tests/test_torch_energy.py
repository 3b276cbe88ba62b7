"""The reference's energy-as-a-resource tests (``tests/test_energy.py``)
against the port: device-class cost models, joule budgets at admission
(exact retry_after, precheck-before-WAL ordering), the power-cap pacer,
hint staleness decay, and fleet routing around a cap-saturated worker.
Services run with ``device="cpu"``; the reference's ``pallas-kernel`` /
``jax-ref`` lanes are the port's ``cuda-kernel`` / ``torch-ref``.  The
cross-package case holds the energy model's prices and the pacer's waits
to the reference's.

The power-cap service case holds the reference's claim (at least one
throttle under the cap) with a cap five times lower than the reference's
0.01 W, and six requests: with requests that trickle in (a WAL fsync each
under a loaded host), a batch refills at 0.01 W in 0.12 s, so the
reference's case can miss the throttle; at 0.002 W it takes 0.6 s."""

import pytest

from repro.service.energy import (
    BIG as JAX_BIG,
    LITTLE as JAX_LITTLE,
    PowerCapPacer as JaxPowerCapPacer,
)
from repro_torch.data.synthetic import ClusterSpec, make_blobs
from repro_torch.service import AdmissionQueue, ClusteringService, MiningClient
from repro_torch.service.dispatch import (
    EXECUTOR_CUDA,
    EXECUTOR_NUMPY_MT,
    EXECUTOR_TORCH_REF,
    SMALL_WORK_THRESHOLD,
    default_registry,
    estimate_work,
)
from repro_torch.service.energy import (
    BIG,
    ENERGY_CROSSOVER_WORK,
    LITTLE,
    P_ACTIVE_WATTS,
    PowerCapPacer,
    classify_work,
    device_class_for,
)
from repro_torch.service.fleet import FleetRouter
from repro_torch.service.fleet.manager import WorkerSpec
from repro_torch.service.fleet import rpc
from repro_torch.service.metrics import HINT_STALENESS_DECAY, ServiceMetrics
from repro_torch.service.queue import EnergyBudgetExceeded, MiningRequest

KM_PARAMS = {"k": 4, "max_iters": 10}


def blob(seed, clusters=4, points=32, features=2):
    x, _, _ = make_blobs(seed, ClusterSpec(features, clusters, points))
    return x.numpy()


def req(tenant="t0", points=32, seed=0):
    return MiningRequest(tenant=tenant, algo="kmeans",
                         data=blob(seed, points=points),
                         params=dict(KM_PARAMS))


# -- device-class model --------------------------------------------------------


def test_device_classes_anchor_the_historical_constants():
    # the little class IS the old scalar model, bit for bit
    assert LITTLE.active_watts == P_ACTIVE_WATTS == 3.0
    assert LITTLE.joules_per_work == 3.0 / 5e7
    assert LITTLE.dispatch_overhead_s == 0.0
    # class crossover coincides with the dispatch routing threshold, so
    # the energy-optimal class and the latency-optimal paradigm agree
    assert ENERGY_CROSSOVER_WORK == float(SMALL_WORK_THRESHOLD)
    # the big class's launch tax is solved so the curves meet there
    assert BIG.modeled_joules(ENERGY_CROSSOVER_WORK) == pytest.approx(
        LITTLE.modeled_joules(ENERGY_CROSSOVER_WORK))
    # strictly cheaper on either side of the boundary
    assert (BIG.modeled_joules(ENERGY_CROSSOVER_WORK / 4)
            > LITTLE.modeled_joules(ENERGY_CROSSOVER_WORK / 4))
    assert (BIG.modeled_joules(ENERGY_CROSSOVER_WORK * 4)
            < LITTLE.modeled_joules(ENERGY_CROSSOVER_WORK * 4))


def test_classify_work_boundary():
    assert classify_work(0.0) is LITTLE
    assert classify_work(ENERGY_CROSSOVER_WORK - 1) is LITTLE
    assert classify_work(ENERGY_CROSSOVER_WORK) is BIG
    # accelerator paradigms are big, host threads little, unknowns little
    assert device_class_for(EXECUTOR_CUDA) is BIG
    assert device_class_for(EXECUTOR_TORCH_REF) is BIG
    assert device_class_for(EXECUTOR_NUMPY_MT) is LITTLE
    assert device_class_for(None) is LITTLE
    assert device_class_for("???") is LITTLE


def test_plans_carry_device_class_and_per_class_price():
    reg = default_registry(device="cpu")
    plan = reg.get(EXECUTOR_TORCH_REF).plan(
        "kmeans", {"k": 4}, batch_size=2, n_max=256, features=2)
    assert plan.device_class == "big"
    assert plan.modeled_joules == pytest.approx(
        BIG.modeled_joules(plan.cost))
    assert plan.summary()["device_class"] == "big"
    little_plan = reg.get(EXECUTOR_NUMPY_MT).plan(
        "kmeans", {"k": 4}, batch_size=2, n_max=256, features=2)
    assert little_plan.device_class == "little"
    assert little_plan.modeled_joules == pytest.approx(
        LITTLE.modeled_joules(little_plan.cost))
    # a measured hint overrides the static class model
    hinted = reg.get(EXECUTOR_TORCH_REF).plan(
        "kmeans", {"k": 4}, batch_size=2, n_max=256, features=2,
        energy_hint=1e-6)
    assert hinted.modeled_joules == pytest.approx(1e-6 * hinted.cost)


def test_candidates_gate_on_device_class_at_the_boundary():
    reg = default_registry(device="cpu")
    # work just under the crossover: little-class paradigms only
    d, k = 2, 4
    n_small = 64
    assert estimate_work("kmeans", n_small, d, 1,
                         {"k": k}) < ENERGY_CROSSOVER_WORK
    small = reg.candidates("kmeans", n_small, d, 1, {"k": k})
    assert small[0] == EXECUTOR_NUMPY_MT
    assert all(device_class_for(nm).name == "little" for nm in small)
    # work at/over the crossover: big-class paradigms compete
    n_big = 4096
    assert estimate_work("kmeans", n_big, d, 8,
                         {"k": k}) >= ENERGY_CROSSOVER_WORK
    big = reg.candidates("kmeans", n_big, d, 8, {"k": k})
    assert all(device_class_for(nm).name == "big" for nm in big)


# -- joule budgets at admission ------------------------------------------------


def test_joule_budget_exact_retry_after_and_refill():
    q = AdmissionQueue(tenant_joule_rate=2.0, tenant_joule_burst=8.0,
                       joule_cost=lambda r: 5.0)
    t0 = 1000.0
    q._take_joules("t0", 5.0, t0)              # fresh budget: 8 -> 3
    with pytest.raises(EnergyBudgetExceeded) as exc_info:
        q._take_joules("t0", 5.0, t0)
    exc = exc_info.value
    # exact: deficit (5 - 3) refills at 2 J/s -> 1.0 s
    assert exc.retry_after == pytest.approx(1.0)
    assert exc.tenant == "t0"
    assert exc.needed_joules == pytest.approx(5.0)
    assert exc.rate == 2.0 and exc.burst == 8.0
    assert q.energy_rejected == 1
    # one instant early still rejects; at exactly t0 + retry it refills
    with pytest.raises(EnergyBudgetExceeded):
        q._take_joules("t0", 5.0, t0 + exc.retry_after - 1e-3)
    q._take_joules("t0", 5.0, t0 + exc.retry_after + 1e-3)


def test_joule_debt_gates_on_full_bucket():
    q = AdmissionQueue(tenant_joule_rate=1.0, tenant_joule_burst=4.0,
                       joule_cost=lambda r: 0.0)
    t0 = 50.0
    # pricier than the whole burst: admitted against a full bucket, the
    # overdraft goes negative (throttled hard, never starved forever)
    q._take_joules("t0", 10.0, t0)
    assert q._joule_buckets["t0"][0] == pytest.approx(-6.0)
    with pytest.raises(EnergyBudgetExceeded) as exc_info:
        q._take_joules("t0", 10.0, t0)
    # refill the deficit up to the gate (a full bucket), not the cost
    assert exc_info.value.retry_after == pytest.approx(10.0)


def test_energy_rejection_never_burns_a_rate_token():
    q = AdmissionQueue(tenant_rate=1e-9, tenant_burst=2,
                       tenant_joule_rate=1e-9, tenant_joule_burst=5.0,
                       joule_cost=lambda r: 5.0 if r.n_points > 64 else 0.0)
    big_points, small_points = 64, 1    # points per cluster (x4 clusters)
    q.submit(req(points=big_points, seed=1))     # burns token 1 + 5 J
    with pytest.raises(EnergyBudgetExceeded):
        q.submit(req(points=big_points, seed=2))  # joules dry
    # the energy rejection must not have burned the second (last) rate
    # token: a cheap request still fits
    q.submit(req(points=small_points, seed=3))
    assert q.energy_rejected == 1 and q.rate_limited == 0


def test_energy_rejection_precedes_wal_append(tmp_path):
    svc = ClusteringService(str(tmp_path / "svc"), max_batch=2,
                            max_wait_s=0.005, cache_entries=0,
                            tenant_joule_rate=1e-6,
                            tenant_joule_burst=1e-3, device="cpu")
    client = MiningClient(service=svc)
    with svc:
        # the first overdraws the (tiny) fresh budget via the debt gate
        h = client.submit("hog", "kmeans", blob(1, points=64),
                          params=dict(KM_PARAMS, seed=1),
                          executor=EXECUTOR_NUMPY_MT)
        appended_after_first = svc.metrics_snapshot()["wal"]["appended"]
        with pytest.raises(EnergyBudgetExceeded):
            client.submit("hog", "kmeans", blob(2, points=64),
                          params=dict(KM_PARAMS, seed=2),
                          executor=EXECUTOR_NUMPY_MT)
        snap = svc.metrics_snapshot()
        # precheck bounced it BEFORE the WAL append: no new entry, no
        # fsync paid for a request the door was always going to refuse
        assert snap["wal"]["appended"] == appended_after_first
        assert snap["energy"]["budget"]["rejections"] == 1
        h.result(120)


# -- joule refunds on cancel/failure -------------------------------------------


def test_joule_refund_restores_budget_caps_at_burst_and_unwinds_debt():
    q = AdmissionQueue(tenant_joule_rate=1e-9, tenant_joule_burst=10.0,
                       joule_cost=lambda r: 6.0)
    t0 = 100.0
    q._take_joules("t0", 6.0, t0)                  # fresh budget: 10 -> 4
    with pytest.raises(EnergyBudgetExceeded):
        q._take_joules("t0", 6.0, t0)              # 4 < 6, refill is ~never
    assert q.refund_joules("t0", 6.0) == pytest.approx(6.0)
    q._take_joules("t0", 6.0, t0)                  # refund reopened the door
    assert q.energy_refunds == 1
    assert q.refunded_joules == pytest.approx(6.0)
    # the credit caps at the burst: refunding 100 J on a bucket at 4 fills
    # to the brim, no further
    assert q.refund_joules("t0", 100.0) == pytest.approx(6.0)
    assert q._joule_buckets["t0"][0] == pytest.approx(10.0)
    # debt unwinds first: a beyond-burst loan is forgiven before tokens pile
    q._take_joules("t0", 25.0, t0)                 # debt gate: 10 -> -15
    assert q._joule_buckets["t0"][0] == pytest.approx(-15.0)
    assert q.refund_joules("t0", 25.0) == pytest.approx(25.0)
    assert q._joule_buckets["t0"][0] == pytest.approx(10.0)
    # no-ops: a tenant never charged, and a disabled budget
    assert q.refund_joules("ghost", 5.0) == 0.0
    assert AdmissionQueue().refund_joules("t0", 5.0) == 0.0


def test_cancel_refunds_charge_and_reopens_admission(tmp_path):
    from repro_torch.service.telemetry import (
        exposition_errors,
        render_prometheus,
    )
    svc = ClusteringService(str(tmp_path / "svc"), max_batch=8,
                            max_wait_s=5.0, cache_entries=0,
                            tenant_joule_rate=1e-9, tenant_joule_burst=6.0,
                            device="cpu")
    svc.queue.joule_cost = lambda r: 5.0
    with svc:
        r1 = svc.submit("t0", "kmeans", blob(1),
                        params=dict(KM_PARAMS, seed=1))
        assert r1.joules_charged == pytest.approx(5.0)
        # the budget is dry: the same tenant's next request bounces
        with pytest.raises(EnergyBudgetExceeded):
            svc.submit("t0", "kmeans", blob(2),
                       params=dict(KM_PARAMS, seed=2))
        # cancel fails the handle synchronously -> the charge comes back
        assert r1.cancel()
        snap = svc.metrics_snapshot()
        assert snap["energy"]["budget"]["refunds"] == 1
        assert snap["energy"]["budget"]["refunded_joules"] == pytest.approx(
            5.0)
        r2 = svc.submit("t0", "kmeans", blob(3),
                        params=dict(KM_PARAMS, seed=3))
        assert r2.joules_charged == pytest.approx(5.0)
        text = render_prometheus(svc.metrics_snapshot())
        assert "energy_budget_refunds_total 1" in text
        assert exposition_errors(text) == []
        r2.cancel()


# -- power-cap pacer -----------------------------------------------------------


class _FakeTime:
    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def clock(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def test_pacer_rejects_nonpositive_cap():
    with pytest.raises(ValueError):
        PowerCapPacer(0.0)
    with pytest.raises(ValueError):
        PowerCapPacer(-1.0)


def test_pacer_paces_at_the_cap_with_fake_clock():
    ft = _FakeTime()
    p = PowerCapPacer(2.0, burst_joules=1.0, clock=ft.clock,
                      sleep=ft.sleep)
    assert p.acquire(0.5) == 0.0            # burst covers it: no wait
    # needs 1.0, has 0.5: the deficit refills at 2 W -> exactly 0.25 s
    assert p.acquire(1.0) == pytest.approx(0.25)
    assert ft.sleeps == [pytest.approx(0.25)]
    snap = p.snapshot()
    assert snap["spent_joules"] == pytest.approx(1.5)
    assert snap["acquires"] == 2 and snap["throttles"] == 1
    assert snap["throttled_s_total"] == pytest.approx(0.25)


def test_pacer_debt_model_and_abort():
    ft = _FakeTime()
    p = PowerCapPacer(2.0, burst_joules=1.0, clock=ft.clock,
                      sleep=ft.sleep)
    # a batch bigger than the whole burst gates on a FULL bucket then
    # borrows the rest: the bucket goes negative, long-run draw <= cap
    assert p.acquire(5.0) == 0.0
    assert p.snapshot()["tokens_joules"] == pytest.approx(-4.0)
    # abort short-circuits the wait without charging the bucket
    spent = p.snapshot()["spent_joules"]
    p.acquire(100.0, abort=lambda: True)
    assert p.snapshot()["spent_joules"] == spent


def test_service_power_cap_throttles_under_load(tmp_path):
    svc = ClusteringService(str(tmp_path / "svc"), max_batch=2,
                            max_wait_s=0.005, cache_entries=0,
                            continuous=False,
                            power_cap_watts=0.002,
                            power_cap_burst_joules=0.001, device="cpu")
    client = MiningClient(service=svc)
    with svc:
        handles = [client.submit(f"t{i}", "kmeans", blob(10 + i, points=32),
                                 params=dict(KM_PARAMS, seed=i),
                                 executor=EXECUTOR_NUMPY_MT)
                   for i in range(6)]
        for h in handles:
            h.result(120)
        energy = svc.metrics_snapshot()["energy"]
    cap = energy["cap"]
    assert energy["power_cap_watts"] == 0.002
    assert cap["spent_joules"] > 0.0
    # >= 2 batches against a burst smaller than one batch's joules: the
    # pacer must have blocked dispatch at least once
    assert cap["throttles"] >= 1
    assert cap["throttled_s_total"] > 0.0


# -- hint staleness decay (regression) ----------------------------------------


def test_stale_energy_hint_decays_toward_class_prior():
    m = ServiceMetrics()
    # one poisoned sample: a pathological batch makes torch-ref look 1000x
    # more expensive than its class prior
    m.record_batch(algo="kmeans", executor=EXECUTOR_TORCH_REF, size=1,
                   capacity=1, n_max=64, exec_s=100.0, work=1e4)
    poisoned = m.energy_hints()[EXECUTOR_TORCH_REF]
    assert poisoned > BIG.joules_per_work * 100
    # pre-fix behavior: the hint would stay poisoned forever and dispatch
    # would starve the paradigm.  Now every batch anyone ELSE runs pulls
    # it toward the static prior.
    for i in range(200):
        m.record_batch(algo="kmeans", executor=EXECUTOR_NUMPY_MT, size=1,
                       capacity=1, n_max=64, exec_s=0.01, work=1e4)
    recovered = m.energy_hints()[EXECUTOR_TORCH_REF]
    expected_keep = (1.0 - HINT_STALENESS_DECAY) ** 200
    assert recovered == pytest.approx(
        BIG.joules_per_work
        + (poisoned - BIG.joules_per_work) * expected_keep)
    assert recovered < poisoned * 0.03
    # the actively-updated executor is NOT decayed at read time
    fresh = m.energy_hints()[EXECUTOR_NUMPY_MT]
    assert fresh == pytest.approx(3.0 * 0.01 / 1e4, rel=0.3)


def test_record_batch_accounts_per_device_class():
    m = ServiceMetrics()
    m.record_batch(algo="kmeans", executor=EXECUTOR_TORCH_REF, size=2,
                   capacity=2, n_max=64, exec_s=2.0, work=1e6,
                   device_class="big")
    m.record_batch(algo="kmeans", executor=EXECUTOR_NUMPY_MT, size=1,
                   capacity=1, n_max=64, exec_s=1.0, work=1e5)
    snap = m.snapshot()
    by_class = snap["energy"]["by_class"]
    assert by_class["big"]["modeled_joules"] == pytest.approx(7.5 * 2.0)
    # class inferred from the executor when the plan did not say
    assert by_class["little"]["modeled_joules"] == pytest.approx(3.0 * 1.0)
    assert snap["totals"]["modeled_joules"] == pytest.approx(15.0 + 3.0)
    # batches just ran, so the watts window sees their joules
    assert snap["energy"]["modeled_watts"] > 0.0


# -- fleet: wire mapping + routing around a saturated worker -------------------


def test_energy_budget_exceeded_round_trips_the_wire():
    exc = EnergyBudgetExceeded("over budget", tenant="t9",
                               retry_after=1.25, needed_joules=7.5,
                               rate=2.0, burst=8.0)
    status, body = rpc.encode_error(exc)
    assert status == 429
    with pytest.raises(EnergyBudgetExceeded) as exc_info:
        rpc.raise_mapped(status, body)
    got = exc_info.value
    assert got.tenant == "t9"
    assert got.retry_after == pytest.approx(1.25)
    assert got.needed_joules == pytest.approx(7.5)
    assert got.rate == 2.0 and got.burst == 8.0


class _StubManager:
    """Just enough WorkerManager surface for FleetRouter.place()."""

    def __init__(self, specs):
        self.specs = {s.name: s for s in specs}

    def live_workers(self):
        return [s for s in self.specs.values() if s.alive]

    def worker(self, name):
        return self.specs[name]

    def on_death(self, fn):
        pass


def _spec(name, cap_saturation=0.0):
    spec = WorkerSpec(name, workdir=f"/nonexistent/{name}")
    spec.alive = True
    spec.health = {"cap_saturation": cap_saturation}
    return spec


def test_router_places_around_cap_saturated_worker():
    saturated = _spec("w-hot", cap_saturation=1.0)
    cool = _spec("w-cool", cap_saturation=0.1)
    router = FleetRouter(_StubManager([saturated, cool]))
    # whatever the hash ring prefers, the power-throttled worker reads
    # as heavily loaded and every tenant spills to the cool one
    placed = {router.place(f"tenant-{i}") for i in range(16)}
    assert placed == {"w-cool"}
    # recovery: once the heartbeat shows headroom again it is placeable
    saturated.health = {"cap_saturation": 0.2}
    placed = {router.place(f"tenant-{i}") for i in range(16)}
    assert "w-hot" in placed


# -- cross-package -------------------------------------------------------------


def test_energy_model_and_pacer_match_the_reference():
    """The same work prices to the same joules per class, and the same
    acquires on a fake clock wait the same seconds."""
    for work in (0.0, 1e3, ENERGY_CROSSOVER_WORK / 4, ENERGY_CROSSOVER_WORK,
                 ENERGY_CROSSOVER_WORK * 4, 1e12):
        assert BIG.modeled_joules(work) == JAX_BIG.modeled_joules(work)
        assert LITTLE.modeled_joules(work) == JAX_LITTLE.modeled_joules(work)
    waits = []
    for cls in (PowerCapPacer, JaxPowerCapPacer):
        ft = _FakeTime()
        p = cls(2.0, burst_joules=1.0, clock=ft.clock, sleep=ft.sleep)
        waits.append([p.acquire(j) for j in (0.5, 1.0, 5.0, 0.1, 3.0)]
                     + [ft.now])
    assert waits[0] == waits[1]
