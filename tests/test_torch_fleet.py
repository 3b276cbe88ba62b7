"""The port's fleet tier against the reference's fleet tests, on the CPU.

The twin of ``tests/test_fleet.py``: consistent-hash placement (join/leave
stability, bounded-load spill), the framed RPC transport and its typed
error mapping, router retry/backoff against stub workers, graceful drain,
rate-shaped WAL replay, the disk-cache byte bound, and two end-to-end
fleets of two worker processes (spawn, sticky streaming, SIGKILL
failover, durable-result adoption; rolling restart and live reload).
Workers and services run with ``device="cpu"``, so the ``cuda-kernel``
lane takes its plain versions.  Parity cases hold the port's ring and
RPC bytes to the reference's.
"""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from repro.service.fleet import hashring as jax_hashring
from repro.service.fleet import rpc as jax_rpc
from repro_torch.service import (
    BacklogFull,
    ClusteringService,
    MiningClient,
    RateLimited,
    ResultCache,
    content_key,
)
from repro_torch.service.faults import read_ledger
from repro_torch.service.fleet import (ConsistentHashRing, FleetRouter,
                                       WorkerManager)
from repro_torch.service.fleet import rpc
from repro_torch.service.fleet.manager import WorkerSpec
from repro_torch.service.queue import RequestDropped, RequestTooLarge
from repro_torch.service.wal import WalLocked

CPU = {"device": "cpu"}


def pts(seed, n=48, d=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20.0, 20.0, size=(3, d)).astype(np.float32)
    return np.concatenate([
        c + rng.normal(0.0, 0.5, size=(n // 3, d)).astype(np.float32)
        for c in centers
    ])


# -- consistent-hash ring -----------------------------------------------------


KEYS = [f"tenant-{i}" for i in range(1000)]


def test_ring_distribution_and_membership():
    ring = ConsistentHashRing(["w0", "w1", "w2"])
    assert len(ring) == 3 and "w1" in ring and "w9" not in ring
    counts = {n: 0 for n in ring.nodes}
    for key in KEYS:
        counts[ring.primary(key)] += 1
    # 64 virtual replicas keep every node within a loose band of the
    # fair share (333) — catastrophic imbalance means a broken ring
    assert all(150 <= c <= 550 for c in counts.values()), counts
    # preference lists visit every node exactly once
    pref = ring.preference("tenant-0")
    assert sorted(pref) == ["w0", "w1", "w2"]


def test_ring_leave_moves_only_departed_keys():
    ring = ConsistentHashRing(["w0", "w1", "w2"])
    before = {key: ring.primary(key) for key in KEYS}
    ring.remove("w1")
    for key in KEYS:
        now = ring.primary(key)
        if before[key] == "w1":
            assert now in ("w0", "w2")       # orphans re-home
        else:
            assert now == before[key]        # nobody else moves


def test_ring_join_moves_keys_only_to_joiner():
    ring = ConsistentHashRing(["w0", "w1"])
    before = {key: ring.primary(key) for key in KEYS}
    ring.add("w2")
    moved = 0
    for key in KEYS:
        now = ring.primary(key)
        if now != before[key]:
            assert now == "w2"               # moves only TO the joiner
            moved += 1
    assert 0 < moved < len(KEYS) // 2        # a share, not a reshuffle


def test_ring_bounded_load_spills_hot_primary():
    ring = ConsistentHashRing(["w0", "w1", "w2"], load_factor=1.25)
    key = "hot-tenant"
    primary = ring.primary(key)
    # idle fleet: placement is the primary
    assert ring.place(key, lambda n: 0, total_load=0) == primary
    # primary saturated past capacity: placement spills clockwise to the
    # next preference, not to an arbitrary node
    cap = ring.capacity(total_load=3)
    load = {n: 0 for n in ring.nodes}
    load[primary] = cap
    spilled = ring.place(key, lambda n: load[n], total_load=3)
    assert spilled != primary
    assert spilled == [n for n in ring.preference(key) if n != primary][0]
    # everyone saturated: falls back to the primary rather than failing
    assert ring.place(key, lambda n: 1 << 20, total_load=3) == primary


def test_ring_capacity_and_validation():
    ring = ConsistentHashRing(["w0", "w1", "w2"], load_factor=1.25)
    # ceil(1.25 * (total+1) / n): the +1 admits the request being placed
    assert ring.capacity(total_load=0) == 1
    assert ring.capacity(total_load=11) == 5
    with pytest.raises(ValueError):
        ConsistentHashRing(["w0"], load_factor=1.0)


# -- RPC framing + typed error mapping ---------------------------------------


def test_rpc_frame_and_result_roundtrip():
    header = {"op": "open", "tenant": "t0", "n": 3}
    payload = rpc.encode_array(pts(1))
    hdr, raw = rpc.unpack_frame(rpc.pack_frame(header, payload))
    assert hdr == header
    assert (rpc.decode_array(raw) == pts(1)).all()

    result = {"labels": np.arange(6, dtype=np.int16),
              "centroids": pts(2), "iters": 7, "note": "ok"}
    out = rpc.decode_result(rpc.encode_result(result))
    assert out["iters"] == 7 and out["note"] == "ok"
    assert (out["labels"] == result["labels"]).all()
    assert (out["centroids"] == result["centroids"]).all()

    with pytest.raises(rpc.RpcError):
        rpc.unpack_frame(b"\xff\xff\xff\xff oversized header length")


@pytest.mark.parametrize("exc, status", [
    (BacklogFull("full", tenant="t0", depth=9, limit=8, retry_after=0.7),
     429),
    (RateLimited("slow down", tenant="t1", retry_after=1.5, rate=2.0,
                 burst=4), 429),
    (WalLocked("locked", root="/x/wal", holder_pid=123, retry_after=0.4),
     503),
    (RequestTooLarge("big", tenant="t2", n_points=10 ** 9), 413),
    (RequestDropped("bye", resubmit=True), 409),
])
def test_rpc_error_mapping_roundtrip(exc, status):
    got_status, body = rpc.encode_error(exc)
    assert got_status == status
    with pytest.raises(type(exc)) as ei:
        rpc.raise_mapped(got_status, body)
    rebuilt = ei.value
    for attr in ("tenant", "retry_after", "root", "n_points", "resubmit"):
        if hasattr(exc, attr):
            assert getattr(rebuilt, attr) == getattr(exc, attr)


def test_rpc_unmapped_error_becomes_remote_error():
    status, body = rpc.encode_error(RuntimeError("lane exploded"))
    assert status == 500
    with pytest.raises(rpc.RemoteError) as ei:
        rpc.raise_mapped(status, body)
    assert ei.value.kind == "RuntimeError"


# -- router retry/backoff against stub workers -------------------------------


def _stub_http(responder):
    """Minimal worker stand-in: POST bodies go through ``responder(path,
    body) -> (status, payload_bytes)``."""
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            status, payload = responder(self.path, self.rfile.read(n))
            self.send_response(status)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class _StubManager:
    """Just enough WorkerManager surface for a FleetRouter."""

    def __init__(self, specs):
        self.specs = {s.name: s for s in specs}
        self.death_subscribers = []

    def live_workers(self):
        return [s for s in self.specs.values() if s.alive]

    def worker(self, name):
        return self.specs[name]

    def on_death(self, fn):
        self.death_subscribers.append(fn)

    def fleet_snapshot(self):
        return {"workers": {n: s.as_dict() for n, s in self.specs.items()},
                "n_workers": len(self.specs),
                "alive": len(self.live_workers()), "dead": 0,
                "takeovers": []}


def _spec(name, port, alive=True):
    spec = WorkerSpec(name, workdir=f"/nonexistent/{name}")
    spec.port = port
    spec.alive = alive
    return spec


def test_router_retries_typed_pressure_with_backoff():
    """A worker answering BacklogFull (with retry_after) is retried, and
    the eventual success resolves the same handle — at-least-once with
    server-paced backoff, invisible to the caller."""
    calls = []

    def responder(path, body):
        calls.append(time.monotonic())
        if len(calls) <= 2:
            status, err = rpc.encode_error(
                BacklogFull("full", tenant="t0", depth=8, limit=8,
                            retry_after=0.15))
            import json
            return status, json.dumps(err).encode()
        return 200, rpc.encode_result(
            {"labels": np.zeros(6, dtype=np.int16), "__worker": "stub"})

    srv = _stub_http(responder)
    manager = _StubManager([_spec("stub", srv.server_address[1])])
    router = FleetRouter(manager, max_attempts=5, backoff_cap=0.5)
    try:
        h = router.submit("t0", "kmeans", pts(3),
                          params={"k": 3, "seed": 0}, executor="torch-ref")
        out = h.result(30)
        assert out["labels"].shape == (6,)
        assert h.worker == "stub"            # meta stripped onto the handle
        assert len(calls) == 3
        assert router.counters["retries"] == 2
        assert router.counters["rejected"] == 0
        # backoff honoured the server's retry_after between attempts
        assert calls[1] - calls[0] >= 0.12
    finally:
        router.close()
        srv.shutdown()


def test_router_exhausts_retries_then_raises_typed():
    def responder(path, body):
        import json
        status, err = rpc.encode_error(
            RateLimited("no", tenant="t0", retry_after=0.01, rate=1.0,
                        burst=1))
        return status, json.dumps(err).encode()

    srv = _stub_http(responder)
    manager = _StubManager([_spec("stub", srv.server_address[1])])
    router = FleetRouter(manager, max_attempts=3, backoff_cap=0.05)
    try:
        h = router.submit("t0", "kmeans", pts(3),
                          params={"k": 3, "seed": 0}, executor="torch-ref")
        with pytest.raises(RateLimited):
            h.result(30)
        assert router.counters["rejected"] == 1
        assert router.counters["retries"] == 3
    finally:
        router.close()
        srv.shutdown()


def test_router_routes_around_dead_worker_and_death_unpins():
    """A transport error marks the worker suspect, so the retry lands on
    the healthy one; a death notification removes the victim from the
    ring and re-pins its sticky tenants to the adopter."""
    def ok(path, body):
        return 200, rpc.encode_result(
            {"labels": np.zeros(4, dtype=np.int16), "__worker": "good"})

    srv = _stub_http(ok)
    dead = _spec("dead", 1)                  # connection refused
    good = _spec("good", srv.server_address[1])
    manager = _StubManager([dead, good])
    router = FleetRouter(manager, max_attempts=6, backoff_cap=0.05)
    try:
        # a tenant whose ring primary is the dead worker — forced to
        # exercise the suspect/re-place path
        tenant = next(t for t in (f"t-{i}" for i in range(200))
                      if router.ring.primary(t) == "dead")
        out = router.submit(tenant, "kmeans", pts(5),
                            params={"k": 3, "seed": 0},
                            executor="torch-ref").result(30)
        assert out["labels"].shape == (4,)
        assert router.counters["retries"] >= 1
        # sticky pins follow the adopter on death
        router._sticky[tenant] = "dead"
        for fn in manager.death_subscribers:
            fn("dead", "good")
        assert router._sticky[tenant] == "good"
        assert "dead" not in router.ring
        assert router.counters["reroutes"] == 1
    finally:
        router.close()
        srv.shutdown()


# -- satellite: graceful drain ------------------------------------------------


def test_stop_drain_finishes_inflight_then_rejects_new(tmp_path):
    """stop(drain=True): everything already admitted completes (WAL fully
    consumed), while submits arriving mid-drain bounce with a retryable
    BacklogFull — the signal a router needs to send them elsewhere."""
    svc = ClusteringService(str(tmp_path / "svc"), max_batch=8,
                            max_wait_s=0.25, device="cpu").start()
    client = MiningClient(service=svc)
    handles = [client.submit(f"t{i}", "kmeans", pts(i),
                             params={"k": 3, "seed": i}, executor="torch-ref")
               for i in range(4)]

    stopper = threading.Thread(
        target=lambda: svc.stop(drain=True, timeout=60.0))
    stopper.start()
    deadline = time.monotonic() + 10.0
    while not svc._draining and time.monotonic() < deadline:
        time.sleep(0.005)
    assert svc._draining
    with pytest.raises(BacklogFull) as ei:
        client.submit("late", "kmeans", pts(9),
                      params={"k": 3, "seed": 9}, executor="torch-ref")
    assert ei.value.retry_after > 0          # retryable, not fatal
    stopper.join(90.0)
    assert not stopper.is_alive()

    for h in handles:
        assert h.result(1)["labels"].shape == (48,)
    # the drain marked every admit consumed: a successor inherits an
    # empty log, not a replay
    svc2 = ClusteringService(str(tmp_path / "svc"), max_batch=8,
                             device="cpu")
    assert svc2.wal.pending() == 0
    svc2.stop()


# -- satellite: rate-shaped replay -------------------------------------------


def test_recover_replay_rate_throttles(tmp_path):
    """recover(replay_rate=) meters WAL replay through a token bucket:
    5 cache-hit replays at 4/s with burst 1 must take ~1 s, where the
    unshaped path is effectively instant."""
    wd = str(tmp_path / "svc")
    data = pts(7)
    params = {"k": 3, "seed": 7}
    svc = ClusteringService(wd, max_batch=1, max_wait_s=0.0, device="cpu")
    client = MiningClient(service=svc)
    with svc:
        client.submit("t0", "kmeans", data, params=params,
                      executor="torch-ref").result(120)
    # simulate a crash that left 5 unconsumed admits for content the
    # spilled cache already holds — replay cost is pure admission
    for _ in range(5):
        svc.wal.append_admit(
            "t0", "kmeans", data, params, executor="torch-ref",
            cache_key=content_key("kmeans", params, data))

    svc2 = ClusteringService(wd, max_batch=1, max_wait_s=0.0, device="cpu")
    c2 = MiningClient(service=svc2)
    with svc2:
        t0 = time.monotonic()
        summary = c2.recover(replay_rate=4.0, replay_burst=1)
        elapsed = time.monotonic() - t0
    assert summary["replayed"] == 5 and summary["cache_hits"] == 5
    # 1 burst token + 4 refills at 4/s: the bucket owes >= ~1 s
    assert elapsed >= 0.8, f"replay not throttled: {elapsed:.3f}s"
    assert svc2.wal.pending() == 0


# -- satellite: disk-cache byte bound ----------------------------------------


def test_cache_disk_byte_bound_evicts_lru(tmp_path):
    result = {"labels": np.zeros(2048, dtype=np.int16)}   # ~4 KiB spilled
    probe = ResultCache(2, spill_dir=str(tmp_path / "probe"))
    probe.put("probe", result)
    per_entry = probe.disk_usage()["disk_bytes"]
    assert per_entry > 0

    # fill unbounded so every file lands, then bound and sweep — the
    # service path triggers the same sweep from put()
    cache = ResultCache(2, spill_dir=str(tmp_path / "spill"))
    for i in range(6):
        cache.put(f"k{i}", result)
        time.sleep(0.02)                     # distinct mtimes = LRU order
    # refresh k0's recency via a disk hit so the sweep must pass over it
    # and evict the stalest files instead
    assert cache.get("k0") is not None
    cache.max_disk_bytes = per_entry * 3 + per_entry // 2
    assert cache.sweep_disk() == 3           # k1, k2, k3: oldest mtimes
    usage = cache.disk_usage()
    assert usage["disk_bytes"] <= cache.max_disk_bytes
    assert usage["disk_files"] == 3
    assert cache.get("k0") is not None       # recency-refreshed: kept
    assert cache.get("k1") is None           # stalest: swept
    stats = cache.stats()
    assert stats["max_disk_bytes"] == cache.max_disk_bytes
    assert stats["disk_evictions"] == 3
    assert stats["disk_files"] == usage["disk_files"]


# -- end-to-end: a real two-worker fleet -------------------------------------


def test_fleet_two_workers_submit_stream_and_failover(tmp_path):
    """One spawn pays for the whole integration surface: placement with
    worker attribution, sticky streaming, then a deterministic in-worker
    SIGKILL (fault harness, not a parent-side kill window) + WAL takeover
    with the durable result served by the adopter."""
    ledger = str(tmp_path / "faults.ledger")
    manager = WorkerManager(
        str(tmp_path / "fleet"), 2,
        worker_config={"max_batch": 4, "max_wait_s": 0.005, **CPU},
        # worker-0 admits but never batches: its requests sit in the
        # WAL window so the takeover has something real to replay
        overrides={"worker-0": {"max_batch": 64, "max_wait_s": 3600.0}},
        heartbeat_interval=0.25,
        # worker-0 SIGKILLs itself inside its SECOND WAL append, after
        # the fsync: the entry is durable but the ACK never leaves —
        # exactly the crash window fleet failover exists for
        fault_specs={"worker-0": "wal.append.after_fsync=kill@2"},
        fault_ledger=ledger)
    manager.start()
    router = FleetRouter(manager)
    try:
        live = next(t for t in (f"t-{i}" for i in range(200))
                    if router.ring.primary(t) == "worker-1")
        out = router.submit(live, "kmeans", pts(11),
                            params={"k": 3, "seed": 11},
                            executor="cuda-kernel")
        assert out.result(120)["labels"].shape == (48,)
        assert out.worker == "worker-1"

        # sticky stream: every op follows the pin to one worker
        stream = router.stream(live, k=3, batch_size=32, seed=0)
        for i in range(3):
            stream.push(pts(20 + i, n=33))
        stream.flush()
        snap = stream.snapshot()
        assert snap["n_seen"] == 99 and snap["initialized"]
        labels = stream.assign(pts(30, n=12))
        assert labels.shape == (12,)
        stream.close()

        # durable admit on the doomed worker, then SIGKILL + takeover
        victim_tenant = next(t for t in (f"t-{i}" for i in range(200))
                             if router.ring.primary(t) == "worker-0")
        h = router.submit(victim_tenant, "kmeans", pts(13),
                          params={"k": 3, "seed": 13},
                          executor="cuda-kernel", durable=True)
        ack = h.admitted(60)
        assert ack["accepted"] and ack["worker"] == "worker-0"

        # the SECOND durable admit trips the armed fault: worker-0 dies
        # by its own hand mid-append (durable, unacked); the router's
        # at-least-once retry re-admits it on worker-1 by content hash
        h2 = router.submit(victim_tenant, "kmeans", pts(14),
                           params={"k": 3, "seed": 14},
                           executor="cuda-kernel", durable=True)
        ack2 = h2.admitted(120)
        assert ack2["accepted"] and ack2["worker"] == "worker-1"

        deadline = time.monotonic() + 30.0
        while not manager.takeovers and time.monotonic() < deadline:
            time.sleep(0.05)
        assert manager.takeovers and (
            manager.takeovers[0]["victim"] == "worker-0")
        assert manager.takeovers[0]["replayed"] >= 1
        # the ledger proves the kill fired where the spec said it would
        assert any(e["point"] == "wal.append.after_fsync"
                   and e["action"] == "kill" and e["hit"] == 2
                   for e in read_ledger(ledger))
        # the adopter serves the admitted work; the tenant re-places
        assert h.result(120)["labels"].shape == (48,)
        assert h2.result(120)["labels"].shape == (48,)
        assert router.place(victim_tenant) == "worker-1"
        assert "worker-0" not in router.ring
    finally:
        router.close()
        manager.stop()


def test_fleet_rolling_restart_and_live_reload(tmp_path):
    """Rolling restart: every worker is replaced (new pids) one at a time
    while durable requests admitted before and during the roll all
    resolve — zero admitted requests lost, no client-visible downtime
    beyond retryable backpressure.  Live reload: one ``router.reload()``
    converges every worker on the same new config epoch, visible in the
    next heartbeat."""
    manager = WorkerManager(
        str(tmp_path / "fleet"), 2,
        worker_config={"max_batch": 4, "max_wait_s": 0.005, **CPU},
        heartbeat_interval=0.25)
    manager.start()
    router = FleetRouter(manager)
    try:
        # live reload fans out and converges on one epoch
        out = router.reload({"tenant_rate": 500.0, "max_backlog": 512})
        assert out["converged"], out
        assert set(out["epochs"]) == {"worker-0", "worker-1"}
        assert set(out["epochs"].values()) == {1}
        # a bad knob is rejected by every worker, applied by none
        bad = router.reload({"tenant_rate": -1.0})
        assert not bad["converged"] and len(bad["errors"]) == 2
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            epochs = {w.health.get("config_epoch")
                      for w in manager.live_workers()}
            if epochs == {1}:
                break
            time.sleep(0.1)
        assert epochs == {1}, "heartbeats never converged on the epoch"

        before = [router.submit(f"t-{i}", "kmeans", pts(40 + i),
                                params={"k": 3, "seed": 40 + i},
                                executor="cuda-kernel", durable=True)
                  for i in range(4)]
        for h in before:
            assert h.admitted(60)["accepted"]
        old_pids = {n: manager.worker(n).pid for n in manager.workers}

        summary = manager.rolling_restart(drain_timeout=60.0)

        assert [r["worker"] for r in summary] == ["worker-0", "worker-1"]
        for rec in summary:
            assert rec["new_pid"] != old_pids[rec["worker"]]
        assert all(w.alive for w in manager.live_workers())
        assert len(manager.live_workers()) == 2
        assert "worker-0" in router.ring and "worker-1" in router.ring
        # nothing admitted before the roll was lost
        for h in before:
            assert h.result(120)["labels"].shape == (48,)
        # and the restarted fleet still takes new work
        after = router.submit("t-after", "kmeans", pts(50),
                              params={"k": 3, "seed": 50},
                              executor="cuda-kernel", durable=True)
        assert after.result(120)["labels"].shape == (48,)
        # config survives within the epoch stream: successors start at
        # epoch 0 of their own process (restart-only knobs need the roll)
        snap = manager.fleet_snapshot()
        assert len(snap["restarts"]) == 2
    finally:
        router.close()
        manager.stop()


# -- parity with the reference package ---------------------------------------


def test_ring_places_keys_like_the_reference():
    """Both packages' rings put every key on the same owner, in the same
    preference order, before and after a membership change, and spill a
    saturated primary to the same node."""
    nodes = ["worker-0", "worker-1", "worker-2"]
    ours, theirs = ConsistentHashRing(nodes), jax_hashring.ConsistentHashRing(
        nodes)
    for key in KEYS:
        assert ours.preference(key) == theirs.preference(key)
    ours.remove("worker-1")
    theirs.remove("worker-1")
    ours.add("worker-3")
    theirs.add("worker-3")
    load = {"worker-0": 5, "worker-2": 0, "worker-3": 1}
    for key in KEYS[:200]:
        assert ours.primary(key) == theirs.primary(key)
        assert (ours.place(key, load.get, total_load=6)
                == theirs.place(key, load.get, total_load=6))
    assert ours.capacity(11) == theirs.capacity(11)


def test_rpc_bytes_match_the_reference():
    """The same result and request frames give identical bytes in both
    packages, and each package decodes the other's."""
    result = {"labels": np.arange(48, dtype=np.int32) % 3,
              "centroids": pts(2)[:3], "inertia": 12.5, "iterations": 7,
              "algo": "kmeans", "executor": "cuda-kernel",
              "n_clusters": 3, "converged": True}
    ours = rpc.encode_result(result)
    assert ours == jax_rpc.encode_result(result)
    back = jax_rpc.decode_result(ours)
    for key, value in result.items():
        assert np.array_equal(back[key], value)
    header = {"tenant": "t0", "algo": "kmeans", "params": {"k": 3},
              "wait": False}
    frame = rpc.pack_frame(header, rpc.encode_array(pts(1)))
    assert frame == jax_rpc.pack_frame(header, jax_rpc.encode_array(pts(1)))
    hdr, raw = rpc.unpack_frame(frame)
    assert hdr == header and (rpc.decode_array(raw) == pts(1)).all()
    for exc in (BacklogFull("full", tenant="t0", depth=9, limit=8,
                            retry_after=0.7),
                RequestTooLarge("big", tenant="t2", n_points=10 ** 9)):
        assert rpc.encode_error(exc) == jax_rpc.encode_error(
            _as_reference(exc))


def _as_reference(exc):
    """The reference package's exception with the same fields."""
    from repro.service import queue as jax_queue
    cls = getattr(jax_queue, type(exc).__name__)
    if isinstance(exc, BacklogFull):
        return cls(str(exc), tenant=exc.tenant, depth=exc.depth,
                   limit=exc.limit, retry_after=exc.retry_after)
    return cls(str(exc), tenant=exc.tenant, n_points=exc.n_points)


def test_worker_without_a_card_exits_before_announcing(tmp_path):
    """A worker asked for the card (the default) on a host without one
    exits non-zero before it announces: the manager raises and names the
    worker's error, and nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the worker would start on it")
    manager = WorkerManager(str(tmp_path / "fleet"), 1,
                            worker_config={"max_batch": 4},
                            spawn_timeout=120.0)
    with pytest.raises(RuntimeError, match="before announcing") as ei:
        manager.start()
    assert "no CUDA device" in str(ei.value)
    manager.stop(drain=False)
