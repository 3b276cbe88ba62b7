"""The reference's async client API tests (``tests/test_client.py``)
against the port: futures, QoS (priority lanes, deadlines, retry_after),
the per-paradigm executor pool (``cuda-kernel`` and ``numpy-mt`` on their
own lanes; on the CPU the kernel lane takes the plain versions), shutdown
semantics, and streaming sessions with checkpointed per-tenant state.
Every service and stream runs with ``device="cpu"``.  Data comes from the
port's generator; the cross-package case passes the reference's draws.

``test_expired_request_pruned_from_staged_batch`` gives its deadline 1 s
of margin where the reference gives 0.05 s: the claim (a request that
expires while staged is pruned before its batch forms) needs the first
poll to come before the deadline, which a loaded host can miss at 0.05 s.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import kmeans as jax_kmeans

from repro_torch.core import dbscan, kmeans
from repro_torch.data.synthetic import ClusterSpec, make_blobs
from repro_torch.service import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    PRIORITY_NORMAL,
    AdmissionQueue,
    BacklogFull,
    ClusteringService,
    MicroBatcher,
    MiningClient,
    MiningRequest,
    RequestCancelled,
    RequestDropped,
    ResultHandle,
    StreamingSession,
)
from repro_torch.service.dispatch import EXECUTOR_CUDA, EXECUTOR_NUMPY_MT

DB_CFG = dbscan.DBSCANConfig.paper_defaults(2)
DB_PARAMS = {"eps": DB_CFG.eps, "min_pts": DB_CFG.min_pts}


def blob(seed, clusters=4, points=32, features=2):
    x, _, _ = make_blobs(seed, ClusterSpec(features, clusters, points))
    return x.numpy()


def req(tenant="t0", priority=PRIORITY_NORMAL, deadline=None, data=None):
    return MiningRequest(tenant=tenant, algo="dbscan",
                         data=data if data is not None else blob(0),
                         params=dict(DB_PARAMS),
                         priority=priority, deadline=deadline)


# -- QoS: priority lanes -------------------------------------------------------


def test_priority_lanes_drain_strict_priority_first():
    q = AdmissionQueue()
    q.submit(req(tenant="bulk", priority=PRIORITY_BATCH))
    q.submit(req(tenant="bulk2", priority=PRIORITY_BATCH))
    q.submit(req(tenant="ui", priority=PRIORITY_INTERACTIVE))
    q.submit(req(tenant="t", priority=PRIORITY_NORMAL))
    drained = q.drain()
    assert [r.tenant for r in drained] == ["ui", "t", "bulk", "bulk2"]


def test_priority_lanes_keep_tenant_fairness_within_lane():
    q = AdmissionQueue()
    for _ in range(4):
        q.submit(req(tenant="chatty", priority=PRIORITY_INTERACTIVE))
    q.submit(req(tenant="quiet", priority=PRIORITY_INTERACTIVE))
    drained = q.drain()
    assert [r.tenant for r in drained[:2]].count("quiet") == 1


def test_batcher_flushes_interactive_groups_first():
    """Priority carries through the staging layer: when several groups are
    ripe at once, the most urgent group's batch is emitted first."""
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=8, max_wait_s=0.0)
    bulk = MiningRequest(tenant="bulk", algo="dbscan",
                         data=blob(0, features=3),
                         params={"eps": 0.3, "min_pts": 4},
                         priority=PRIORITY_BATCH)
    ui = MiningRequest(tenant="ui", algo="dbscan", data=blob(0),
                       params=dict(DB_PARAMS),
                       priority=PRIORITY_INTERACTIVE)
    q.submit(bulk)
    q.submit(ui)
    batches = b.poll()
    assert [batch.priority for batch in batches] == [PRIORITY_INTERACTIVE,
                                                     PRIORITY_BATCH]


# -- QoS: deadlines ------------------------------------------------------------


def test_expired_request_dropped_at_drain_never_dispatched():
    """An expired request fails with RequestDropped at drain time and is
    not handed to the batcher — it never occupies a batch slot."""
    q = AdmissionQueue()
    expired = req(tenant="late", deadline=time.time() - 1.0)
    live = req(tenant="ok")
    q.submit(expired)
    q.submit(live)
    drained = q.drain()
    assert [r.tenant for r in drained] == ["ok"]
    assert q.expired == 1
    assert expired.done()
    with pytest.raises(RequestDropped, match="deadline"):
        expired.wait(0)


def test_expired_request_pruned_from_staged_batch():
    """A request that expires *after* staging (deadline between drain and
    batch formation) is pruned before the batch forms."""
    q = AdmissionQueue()
    b = MicroBatcher(q, max_batch=8, max_wait_s=10.0)
    soon = time.time() + 1.0
    q.submit(req(tenant="late", deadline=soon))
    q.submit(req(tenant="ok"))
    assert b.poll() == []          # staged, nothing ripe
    assert b.pending() == 2
    time.sleep(max(0.0, soon - time.time()) + 0.01)   # expires while staged
    batches = b.poll(now=time.time() + 60.0)   # force the wait flush
    assert len(batches) == 1
    assert [r.tenant for r in batches[0].requests] == ["ok"]


def test_service_level_ttl_expiry(tmp_path):
    """ttl converts to a deadline; a request still queued past it fails
    with RequestDropped before any batch slot is spent on it."""
    svc = ClusteringService(str(tmp_path), max_batch=8, max_wait_s=5.0,
                            device="cpu")
    client = MiningClient(service=svc)   # engine deliberately NOT started
    h = client.submit("t", "dbscan", blob(1), params=DB_PARAMS, ttl=0.01)
    time.sleep(0.03)
    svc.start()                          # drains only after expiry
    with pytest.raises(RequestDropped):
        h.result(30)
    svc.stop()
    assert svc.metrics_snapshot()["queue_expired"] == 1


def test_submit_past_deadline_fails_immediately(tmp_path):
    svc = ClusteringService(str(tmp_path), device="cpu")
    client = MiningClient(service=svc)
    h = client.submit("t", "dbscan", blob(1), params=DB_PARAMS,
                      deadline=time.time() - 1.0)
    assert h.done()
    with pytest.raises(RequestDropped):
        h.result(0)


# -- QoS: structured BacklogFull ----------------------------------------------


def test_backlog_full_carries_structured_fields():
    q = AdmissionQueue(max_backlog=4, max_per_tenant=2)
    q.submit(req(tenant="a"))
    q.submit(req(tenant="a"))
    with pytest.raises(BacklogFull) as exc:
        q.submit(req(tenant="a"))
    e = exc.value
    assert e.tenant == "a" and e.depth == 2 and e.limit == 2
    assert e.retry_after > 0
    q.submit(req(tenant="b"))
    q.submit(req(tenant="c"))
    with pytest.raises(BacklogFull) as exc:
        q.submit(req(tenant="d"))
    e = exc.value
    assert e.tenant is None and e.depth == 4 and e.limit == 4
    assert 0 < e.retry_after <= 5.0


def test_retry_after_tracks_drain_rate():
    q = AdmissionQueue(max_backlog=2)
    q.submit(req(tenant="a"))
    q.submit(req(tenant="b"))
    with pytest.raises(BacklogFull) as exc:
        q.submit(req(tenant="c"))
    assert exc.value.retry_after == pytest.approx(0.1)  # no drain seen yet
    q.drain()
    q.submit(req(tenant="a"))
    q.submit(req(tenant="b"))
    with pytest.raises(BacklogFull) as exc:
        q.submit(req(tenant="c"))
    assert exc.value.retry_after > 0    # estimated from the drain EWMA


# -- ResultHandle: the future protocol ----------------------------------------


def test_result_handle_future_protocol(tmp_path):
    with ClusteringService(str(tmp_path), max_batch=2,
                           max_wait_s=0.005, device="cpu") as svc:
        client = MiningClient(service=svc)
        seen = threading.Event()
        h = client.submit("t", "dbscan", blob(2), params=DB_PARAMS)
        assert isinstance(h, ResultHandle)
        h.add_done_callback(lambda handle: seen.set())
        result = h.result(300)
        assert h.done() and h.exception(0) is None
        assert (result["labels"] == dbscan.fit_oracle(blob(2), DB_CFG)).all()
        assert seen.wait(5)
        # callbacks registered after completion fire immediately
        late = threading.Event()
        h.add_done_callback(lambda handle: late.set())
        assert late.is_set()
        assert h.cancel() is False      # already done


def test_raising_done_callback_is_isolated(tmp_path):
    """A user callback that raises must not strand the other requests of
    the same batch (resolution loops over them on the same thread)."""
    with ClusteringService(str(tmp_path), max_batch=4,
                           max_wait_s=0.05, cache_entries=0,
                           device="cpu") as svc:
        client = MiningClient(service=svc)
        h1 = client.submit("a", "dbscan", blob(1), params=DB_PARAMS)
        h1.add_done_callback(lambda h: 1 / 0)
        h2 = client.submit("b", "dbscan", blob(2), params=DB_PARAMS)
        assert h2.result(300)["n_clusters"] >= 1
        assert h1.result(300)["n_clusters"] >= 1


def test_cancel_before_dispatch(tmp_path):
    # not started: nothing drains
    svc = ClusteringService(str(tmp_path), device="cpu")
    client = MiningClient(service=svc)
    h = client.submit("t", "dbscan", blob(3), params=DB_PARAMS)
    assert h.cancel() is True
    with pytest.raises(RequestCancelled):
        h.result(0)
    svc.start()
    svc.stop()   # the cancelled request must not resurface anywhere


# -- executor pool -------------------------------------------------------------


def test_lane_pool_runs_both_paradigms(tmp_path):
    """Pinned numpy-mt and cuda-kernel requests run on their own lanes;
    both lanes report batches (the pool's health invariant)."""
    with ClusteringService(str(tmp_path), max_batch=2,
                           max_wait_s=0.002, cache_entries=0,
                           device="cpu") as svc:
        client = MiningClient(service=svc)
        handles = []
        for i in range(6):
            lane = (EXECUTOR_NUMPY_MT, EXECUTOR_CUDA)[i % 2]
            handles.append(client.submit(
                f"t{i % 3}", "kmeans", blob(10 + i, points=12),
                params={"k": 3, "seed": i, "max_iters": 20}, executor=lane))
        for h in handles:
            assert h.result(600)["iterations"] >= 1
    lanes = svc.metrics_snapshot()["lanes"]
    assert lanes[EXECUTOR_NUMPY_MT]["batches"] >= 1
    assert lanes[EXECUTOR_CUDA]["batches"] >= 1
    assert lanes[EXECUTOR_NUMPY_MT]["busy_s"] > 0
    assert lanes[EXECUTOR_CUDA]["busy_s"] > 0


def test_least_loaded_assignment_prefers_idle_lane():
    """With equal load the dispatcher takes the cost model's first pick;
    once that lane is loaded, a spill lane gets the next batch."""
    from repro_torch.service.service import ExecutorLane

    class _Batch:
        priority = PRIORITY_NORMAL

    a, b = ExecutorLane("a"), ExecutorLane("b")
    assert min((a, b), key=lambda ln: ln.load) is a   # stable tiebreak
    a.put(_Batch(), est=100.0)                        # load lane a
    assert min((a, b), key=lambda ln: ln.load) is b


def test_lane_queue_orders_by_priority():
    """An interactive batch enqueued behind bulk batches is dequeued
    first; the shutdown sentinel always drains last."""
    from repro_torch.service.service import ExecutorLane

    class _Batch:
        def __init__(self, priority):
            self.priority = priority

    lane = ExecutorLane("x")
    lane.put(_Batch(PRIORITY_BATCH), est=1.0)
    lane.put_sentinel()
    lane.put(_Batch(PRIORITY_INTERACTIVE), est=1.0)
    order = [lane.batches.get()[2] for _ in range(3)]
    assert order[0].priority == PRIORITY_INTERACTIVE
    assert order[1].priority == PRIORITY_BATCH
    assert order[2] is None                           # sentinel last


# -- shutdown fails pending futures (the hang fix) ----------------------------


def test_stop_fails_pending_futures_no_hang(tmp_path):
    """A caller blocked in result() with no timeout must not hang after
    stop(): every still-pending handle is failed."""
    # never started: nothing drains
    svc = ClusteringService(str(tmp_path), device="cpu")
    client = MiningClient(service=svc)
    h = client.submit("t", "dbscan", blob(4), params=DB_PARAMS)
    waiter_result = {}

    def waiter():
        try:
            h.result()                       # no timeout: the old hang
        except RequestDropped as e:
            waiter_result["error"] = e

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    assert t.is_alive()                      # genuinely blocked
    svc.stop()
    t.join(10)
    assert not t.is_alive()
    assert isinstance(waiter_result.get("error"), RequestDropped)


def test_submit_after_stop_fails_fast(tmp_path):
    svc = ClusteringService(str(tmp_path), device="cpu").start()
    svc.stop()
    client = MiningClient(service=svc)
    h = client.submit("t", "dbscan", blob(5), params=DB_PARAMS)
    with pytest.raises(RequestDropped):
        h.result(0)


# -- minibatch state plumbing --------------------------------------------------


def test_minibatch_state_round_trip_and_step():
    x = torch.as_tensor(blob(20, clusters=3, points=64))
    cfg = kmeans.KMeansConfig(k=3, use_kernel=False)
    state = kmeans.minibatch_init(0, x[:32], cfg)
    assert state.step == 0 and state.n_seen == 0
    state = kmeans.minibatch_step(state, x[:32], cfg)
    state = kmeans.minibatch_step(state, x[32:64], cfg)
    assert state.step == 2 and state.n_seen == 64
    tree = state.as_tree()
    back = kmeans.MiniBatchState.from_tree(tree)
    np.testing.assert_array_equal(np.asarray(back.centroids),
                                  np.asarray(state.centroids))
    assert back.step == 2 and back.n_seen == 64


# -- streaming sessions --------------------------------------------------------


def _stream_points(seed, n):
    x, _, _ = make_blobs(seed, ClusterSpec(2, 3, 256))
    x = x.numpy()
    idx = np.random.RandomState(seed).permutation(x.shape[0])[:n]
    return x[idx]


def test_streaming_session_learns_and_assigns(tmp_path):
    with StreamingSession(str(tmp_path), "alice", k=3, batch_size=32,
                          seed=1, device="cpu") as sess:
        for i in range(6):
            sess.push(_stream_points(i, 48))
        snap = sess.snapshot()
        assert snap["initialized"] and snap["step"] >= 6
        assert snap["centroids"].shape == (3, 2)
        labels = sess.assign(_stream_points(99, 16))
        assert labels.shape == (16,) and labels.dtype == np.int16
        assert set(np.unique(labels)) <= {0, 1, 2}


def test_streaming_session_survives_kill_and_resumes(tmp_path):
    """The SIGTERM/resume cycle: a session abandoned without close() (the
    process died) reopens from its last checkpoint with centroid state
    intact, and keeps learning."""
    sess = StreamingSession(str(tmp_path), "bob", "clicks", k=3,
                            batch_size=32, checkpoint_every=1, seed=2,
                            device="cpu")
    for i in range(4):
        sess.push(_stream_points(i, 32))
    snap_before = sess.snapshot()
    assert snap_before["step"] >= 4
    del sess                 # simulated SIGKILL: no close(), no final flush

    resumed = StreamingSession(str(tmp_path), "bob", "clicks", k=3,
                               batch_size=32, checkpoint_every=1, seed=2,
                               device="cpu")
    snap_after = resumed.snapshot()
    assert snap_after["initialized"]
    assert snap_after["step"] == snap_before["step"]
    np.testing.assert_array_equal(snap_after["centroids"],
                                  snap_before["centroids"])
    resumed.push(_stream_points(9, 32))
    assert resumed.snapshot()["step"] == snap_before["step"] + 1
    resumed.close()


def test_streaming_session_seeds_when_batch_size_below_k(tmp_path):
    """Seeding must cover k points even when batch_size < k (the take is
    widened to k); no points are lost."""
    sess = StreamingSession(str(tmp_path), "tiny", k=8, batch_size=4, seed=5,
                            device="cpu")
    assert sess.push(_stream_points(1, 8)) >= 1
    snap = sess.snapshot()
    assert snap["initialized"] and snap["centroids"].shape == (8, 2)
    assert snap["n_seen"] == 8
    sess.close()


def test_streaming_session_rejects_k_mismatch_on_reopen(tmp_path):
    with StreamingSession(str(tmp_path), "t", k=3, batch_size=16,
                          checkpoint_every=1, seed=6, device="cpu") as sess:
        sess.push(_stream_points(1, 32))
    with pytest.raises(ValueError, match="k=3"):
        StreamingSession(str(tmp_path), "t", k=8, batch_size=16,
                         device="cpu")


def test_streaming_sessions_isolate_tenants(tmp_path):
    a = StreamingSession(str(tmp_path), "alice", k=2, batch_size=16, seed=3,
                         device="cpu")
    b = StreamingSession(str(tmp_path), "bob", k=2, batch_size=16, seed=4,
                         device="cpu")
    a.push(_stream_points(1, 32))
    b.push(_stream_points(2, 32) + 100.0)   # shifted: different model
    a.close()
    b.close()
    ca = a.snapshot()["centroids"]
    cb = b.snapshot()["centroids"]
    assert not np.allclose(ca, cb)
    # reopening each tenant gets its own state back
    a2 = StreamingSession(str(tmp_path), "alice", k=2, batch_size=16, seed=3,
                          device="cpu")
    np.testing.assert_array_equal(a2.snapshot()["centroids"], ca)


def test_client_stream_roundtrip(tmp_path):
    """client.stream() persists under the service workdir so a new client
    over the same workdir resumes the same model."""
    with ClusteringService(str(tmp_path), device="cpu") as svc:
        client = MiningClient(service=svc)
        sess = client.stream("carol", "events", k=2, batch_size=16,
                             checkpoint_every=1)
        sess.push(_stream_points(5, 40))
        sess.close()                      # flushes the partial remainder
        centroids = sess.snapshot()["centroids"]
    with ClusteringService(str(tmp_path), device="cpu") as svc2:
        client2 = MiningClient(service=svc2)
        sess2 = client2.stream("carol", "events", k=2, batch_size=16)
        np.testing.assert_array_equal(
            sess2.snapshot()["centroids"], centroids)


def test_client_owns_engine_lifecycle(tmp_path):
    with MiningClient(workdir=str(tmp_path), max_batch=2,
                      max_wait_s=0.005, device="cpu") as client:
        h = client.submit("t", "kmeans", blob(6, points=16),
                          params={"k": 2, "seed": 0, "max_iters": 10})
        assert h.result(300)["iterations"] >= 1
    # close() stopped the owned engine: new submissions fail fast
    h2 = client.submit("t", "dbscan", blob(7), params=DB_PARAMS)
    with pytest.raises(RequestDropped):
        h2.result(0)


# -- cross-package -------------------------------------------------------------


def test_minibatch_steps_match_the_reference():
    """From the same model state (the checkpoint tree) and the same
    mini-batches, the port's Sculley steps stay within 1e-5 of the
    reference's."""
    x = blob(21, clusters=3, points=96)
    cfg = kmeans.KMeansConfig(k=3, use_kernel=False)
    jcfg = jax_kmeans.KMeansConfig(k=3, use_kernel=False)
    tree = {"centroids": x[:3].copy(), "counts": np.zeros(3, np.float32),
            "step": np.int64(0), "n_seen": np.int64(0)}
    state = kmeans.MiniBatchState.from_tree(tree)
    jstate = jax_kmeans.MiniBatchState.from_tree(tree)
    for i in range(0, x.shape[0], 32):
        state = kmeans.minibatch_step(state, x[i:i + 32], cfg)
        jstate = jax_kmeans.minibatch_step(jstate, x[i:i + 32], jcfg)
    got, ref = state.as_tree(), jstate.as_tree()
    np.testing.assert_allclose(got["centroids"], ref["centroids"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    assert got["step"] == ref["step"] and got["n_seen"] == ref["n_seen"]
