"""The reference's tracing + telemetry tests (``tests/test_telemetry.py``)
against the port: span ring semantics, per-stage latency metrics, the
bounded compiled-shape tracker, monotonic deadlines, the Prometheus
exposition, the rotating event log, SLO burn rates, and trace continuity
across both restart paths (in-process WAL replay and a real SIGKILL
mid-execution with resume in a fresh process, whose script imports
``repro_torch`` only).  Every service runs with ``device="cpu"``; the
reference's ``jax-ref`` lane is the port's ``torch-ref``.  Cross-package
cases hold the Chrome-trace export, the SLO evaluator and the exposition
validator to the reference's on the same inputs."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from repro_torch.core.cancellation import CancelReason
from repro_torch.service import (
    ClusteringService,
    JobSuspended,
    MiningClient,
    RequestTracer,
    SLOEvaluator,
    TelemetryServer,
    chrome_trace,
    exposition_errors,
    read_events,
    read_spans,
    render_prometheus,
)
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.telemetry import EventLog
from repro.service import (
    SLOEvaluator as JaxSLOEvaluator,
    chrome_trace as jax_chrome_trace,
    exposition_errors as jax_exposition_errors,
    render_prometheus as jax_render_prometheus,
)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def pts(seed, n=48, d=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20.0, 20.0, size=(3, d)).astype(np.float32)
    return np.concatenate([
        c + rng.normal(0.0, 0.5, size=(n // 3, d)).astype(np.float32)
        for c in centers
    ])


# -- span ring -----------------------------------------------------------------


def test_ring_eviction_bounds_memory_and_counts_drops():
    tr = RequestTracer(capacity=4)
    for i in range(10):
        tr.emit("t1", f"s{i}", time.time(), 0.001)
    st = tr.stats()
    assert len(tr.spans()) == 4
    assert st["emitted"] == 10 and st["dropped"] == 6
    # the survivors are the newest four
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]


def test_concurrent_span_emission_is_thread_safe():
    tr = RequestTracer(capacity=10_000)
    n_threads, per_thread = 8, 200

    def work(k):
        for i in range(per_thread):
            tr.emit(f"trace-{k}", "stage", time.time(), 0.0, i=i)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = tr.stats()
    assert st["emitted"] == n_threads * per_thread
    assert st["dropped"] == 0
    assert st["traces"] == n_threads


def test_begin_finish_and_error_attrs():
    tr = RequestTracer()
    with pytest.raises(ValueError):
        with tr.begin("t1", "work"):
            raise ValueError("boom")
    (span,) = tr.spans()
    assert span.name == "work" and "boom" in span.attrs["error"]
    assert span.dur_s is not None and span.dur_s >= 0.0


def test_chrome_trace_export_shape():
    tr = RequestTracer()
    tr.emit("t1", "execute", time.time(), 0.25, executor="torch-ref")
    doc = chrome_trace([s.as_dict() for s in tr.spans()])
    (ev,) = doc["traceEvents"]
    assert ev["ph"] == "X" and ev["name"] == "execute"
    assert ev["dur"] == pytest.approx(250_000)          # microseconds
    assert ev["args"]["executor"] == "torch-ref"
    json.dumps(doc)                                     # serialisable


def test_sink_failures_never_propagate():
    def bad_sink(event, payload):
        raise RuntimeError("sink down")

    tr = RequestTracer(sink=bad_sink)
    tr.emit("t1", "s", time.time(), 0.0)               # must not raise
    with tr.begin("t1", "b", announce=True):
        pass
    assert tr.stats()["emitted"] == 2


# -- stage metrics + bounded shape tracker ------------------------------------


def test_record_stage_feeds_snapshot_breakdown():
    m = ServiceMetrics()
    for i in range(10):
        m.record_stage("execute", 0.010 * (i + 1), executor="torch-ref")
    m.record_stage("wal_append", 0.002)
    snap = m.snapshot()
    ex = snap["stages"]["execute"]
    assert ex["count"] == 10
    assert 0.0 < ex["p50_s"] <= ex["p99_s"] <= 0.1
    assert "torch-ref" in ex["by_executor"]
    assert snap["stages"]["wal_append"]["count"] == 1


def test_compiled_shape_tracker_is_bounded_lru():
    m = ServiceMetrics(max_tracked_shapes=4)
    for i in range(6):
        m.record_batch(algo="kmeans", executor="torch-ref", size=1,
                       capacity=1, n_max=64 + i, exec_s=0.01,
                       real_points=32)
    snap = m.snapshot()["bucketing"]
    assert snap["recompiles"] == 6
    assert snap["tracked_shapes"] == 4
    assert snap["shape_evictions"] == 2
    # a shape still tracked does NOT recount...
    m.record_batch(algo="kmeans", executor="torch-ref", size=1, capacity=1,
                   n_max=69, exec_s=0.01, real_points=32)
    assert m.snapshot()["bucketing"]["recompiles"] == 6
    # ...but an evicted one does (mirrors a bounded executable cache)
    m.record_batch(algo="kmeans", executor="torch-ref", size=1, capacity=1,
                   n_max=64, exec_s=0.01, real_points=32)
    assert m.snapshot()["bucketing"]["recompiles"] == 7


def test_failure_reasons_capped_and_windowed():
    m = ServiceMetrics(window=8)
    for i in range(4):
        m.record_failure("ValueError")
    for i in range(8):
        m.record_request(tenant="t", algo="kmeans", executor="e",
                         latency_s=0.01)
    snap = m.snapshot()["errors"]
    assert snap["total_failures"] == 4
    assert snap["by_reason"]["ValueError"] == 4
    assert snap["window_outcomes"] == 8                 # window=8, full
    assert snap["window_error_rate"] == 0.0             # failures rolled out


# -- monotonic deadlines -------------------------------------------------------


def test_submit_ttl_uses_monotonic_clock(tmp_path):
    svc = ClusteringService(str(tmp_path / "a"), wal=False, device="cpu")
    client = MiningClient(service=svc)
    try:
        h = client.submit("t0", "kmeans", pts(0),
                          params={"k": 3, "seed": 0}, ttl=3600.0)
        req = h._request
        assert req.deadline_mono is not None
        # a wall-clock jump must NOT expire the request: expired() judges
        # the monotonic deadline, not the absolute one
        assert not req.expired(time.time() + 10_000)
        assert req.deadline is not None                  # API stays absolute
    finally:
        svc.stop()

    svc2 = ClusteringService(str(tmp_path / "b"), wal=False, device="cpu")
    c2 = MiningClient(service=svc2)
    try:
        h = c2.submit("t0", "kmeans", pts(1),
                      params={"k": 3, "seed": 1}, ttl=0.01)
        time.sleep(0.05)
        assert h._request.expired()
    finally:
        svc2.stop()


# -- SLO evaluator -------------------------------------------------------------


def test_slo_burn_rates():
    slo = SLOEvaluator(latency_target_s=0.1, latency_percentile=90.0,
                       error_rate_target=0.1)
    # 2 of 10 over target; budget is 10% -> burn 2.0
    lat = [0.01] * 8 + [0.5, 0.5]
    out = slo.evaluate(lat, failures=1, outcomes=20)
    assert out["latency_burn_rate"] == pytest.approx(2.0)
    assert out["observed_error_rate"] == pytest.approx(0.05)
    assert out["errors_burn_rate"] == pytest.approx(0.5)
    assert not out["ok"]                                 # p90 over target
    ok = slo.evaluate([0.01] * 10, failures=0, outcomes=10)
    assert ok["ok"] and ok["latency_burn_rate"] == 0.0


# -- Prometheus exposition -----------------------------------------------------


def test_render_prometheus_from_live_snapshot(tmp_path):
    svc = ClusteringService(str(tmp_path), max_batch=2, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc:
        hs = [client.submit(f"t{i}", "kmeans", pts(i),
                            params={"k": 3, "seed": i},
                            executor="numpy-mt")
              for i in range(3)]
        for h in hs:
            h.result(300)
    text = render_prometheus(svc.metrics_snapshot())
    assert exposition_errors(text) == []
    for needle in ("repro_requests_total 3.0",
                   "repro_slo_burn_rate{slo=\"latency\"}",
                   "repro_slo_burn_rate{slo=\"errors\"}",
                   "stage=\"execute\"",
                   "stage=\"wal_append\"",
                   "repro_executor_modeled_joules{executor=\"numpy-mt\"}",
                   "repro_executor_host_seconds_total",
                   "repro_wal_appended 3.0"):
        assert needle in text, needle


def test_exposition_validator_rejects_garbage():
    assert exposition_errors("repro_x{bad 1.0\n")
    assert exposition_errors("orphan_sample 1.0\n")      # no TYPE line
    good = ("# HELP a_b a\n# TYPE a_b gauge\n"
            'a_b{l="x y \\"z\\""} 1.5\n')
    assert exposition_errors(good) == []


def test_telemetry_http_endpoints(tmp_path):
    svc = ClusteringService(str(tmp_path), max_batch=2, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc, TelemetryServer(svc.metrics_snapshot,
                              tracer=svc.tracer) as ts:
        h = client.submit("t0", "kmeans", pts(5),
                          params={"k": 3, "seed": 5}, executor="numpy-mt")
        h.result(300)
        base = f"http://127.0.0.1:{ts.port}"
        metrics = urllib.request.urlopen(base + "/metrics", timeout=30)
        assert metrics.headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert exposition_errors(metrics.read().decode()) == []
        snap = json.load(urllib.request.urlopen(base + "/snapshot",
                                                timeout=30))
        assert snap["totals"]["requests"] == 1
        doc = json.load(urllib.request.urlopen(
            base + f"/trace?id={h.trace_id}", timeout=30))
        assert any(ev["name"] == "execute" for ev in doc["traceEvents"])
        assert urllib.request.urlopen(
            base + "/healthz", timeout=30).read() == b"ok\n"


# -- event log -----------------------------------------------------------------


def test_event_log_rotation_and_retention(tmp_path):
    root = str(tmp_path / "ev")
    log = EventLog(root, max_bytes=4096, keep=3)
    for i in range(400):
        log.emit("filler", i=i, pad="x" * 64)
    log.close()
    files = sorted(os.listdir(root))
    assert len(files) == 3                               # retention bound
    assert log.rotations > 0
    events = list(read_events(root))
    assert events and all(e["event"] == "filler" for e in events)
    # a new process-alike continues the last (non-full) file
    log2 = EventLog(root, max_bytes=4096, keep=3)
    log2.emit("after", marker=True)
    log2.close()
    assert sorted(os.listdir(root))[-1] == files[-1] or \
        len(os.listdir(root)) == 3
    assert any(e["event"] == "after" for e in read_events(root))


def test_event_log_reopen_after_close(tmp_path):
    log = EventLog(str(tmp_path / "ev"))
    log.emit("one")
    log.close()
    log.emit("dropped")                                   # closed: no-op
    log.reopen()
    log.emit("two")
    log.close()
    names = [e["event"] for e in read_events(str(tmp_path / "ev"))]
    assert names == ["one", "two"]


# -- end-to-end traces ---------------------------------------------------------


def test_request_trace_covers_every_stage(tmp_path):
    svc = ClusteringService(str(tmp_path), max_batch=4, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc:
        h = client.submit("t0", "kmeans", pts(9),
                          params={"k": 3, "seed": 9}, executor="torch-ref")
        h.result(300)
        assert h.trace_id
        names = {s["name"] for s in client.trace(h.trace_id)}
    assert {"cache_lookup", "precheck", "wal_append", "enqueue",
            "queue_wait", "batch_form", "lane_wait", "plan", "execute",
            "deliver"} <= names
    # every span of the export belongs to this trace
    assert all(s["trace_id"] == h.trace_id
               for s in svc.export_trace(h.trace_id))


def test_wal_replay_continues_the_original_trace(tmp_path):
    """In-process crash stand-in: admit without ever batching, 'restart'
    as a second service over the same workdir, recover() — the replayed
    request must keep the dead submission's trace id, and the merged
    export must show both lifetimes (wal_append from the first, execute
    from the second)."""
    wd = str(tmp_path / "svc")
    svc = ClusteringService(wd, max_batch=64, max_wait_s=3600.0, device="cpu")
    client = MiningClient(service=svc)
    svc.start()
    h = client.submit("t0", "kmeans", pts(3), params={"k": 3, "seed": 3},
                      executor="torch-ref")
    original_trace = h.trace_id
    svc.stop(preempt=True)                    # queue dies, WAL survives

    svc2 = ClusteringService(wd, max_batch=4, max_wait_s=0.005, device="cpu")
    c2 = MiningClient(service=svc2)
    with svc2:
        summary = c2.recover()
        assert summary["replayed"] == 1
        (rh,) = summary["requests"]
        assert rh.trace_id == original_trace
        rh.result(300)
        names = {s["name"] for s in svc2.export_trace(original_trace)}
    assert {"wal_append", "wal_replay", "queue_wait",
            "execute", "deliver"} <= names


def test_preempt_and_resume_is_one_trace(tmp_path):
    """The tentpole acceptance: a request preempted mid-execution and
    resumed by a *fresh service* exports as ONE trace containing the WAL
    append, the queue wait, BOTH execute attempts (first suspended, second
    resumed), and the resume boundary marker."""
    wd = str(tmp_path / "svc")
    svc = ClusteringService(wd, max_batch=1, max_wait_s=0.0,
                            checkpoint_every=1, device="cpu")
    client = MiningClient(service=svc)

    # deterministic mid-batch preemption: piggyback on the executor's
    # progress hook to cancel the service token after a few item events
    orig_run = svc.executor.run_batch

    def run_with_hook(batch, **kw):
        kw["progress_hook"] = (
            lambda j, i, e: e == 2 and svc.token.cancel(
                CancelReason.PREEMPTION))
        return orig_run(batch, **kw)

    svc.executor.run_batch = run_with_hook
    svc.start()
    h = client.submit("t0", "dbscan", pts(7, n=384),
                      params={"eps": 0.6, "min_pts": 4},
                      executor="torch-ref")
    trace_id = h.trace_id
    with pytest.raises(JobSuspended):
        h.result(300)
    svc.stop(preempt=True)

    svc2 = ClusteringService(wd, device="cpu")
    outcomes = svc2.resume_suspended()
    assert len(outcomes) == 1 and outcomes[0].resumed
    spans = svc2.export_trace(trace_id)
    assert spans and all(s["trace_id"] == trace_id for s in spans)
    names = [s["name"] for s in spans]
    executes = [s for s in spans if s["name"] == "execute"]
    assert "wal_append" in names and "queue_wait" in names
    assert "suspend" in names and "resume" in names
    assert len(executes) == 2
    by_resumed = sorted(executes, key=lambda s: bool(s["attrs"]["resumed"]))
    assert by_resumed[0]["attrs"]["suspended"] is True
    assert by_resumed[1]["attrs"]["resumed"] is True
    svc2.stop()


_KILL_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.service import ClusteringService, MiningClient, read_spans

rng = np.random.default_rng(41)
centers = rng.uniform(-20.0, 20.0, size=(3, 2)).astype(np.float32)
x = np.concatenate([c + rng.normal(0.0, 0.5, size=(128, 2))
                    .astype(np.float32) for c in centers])
svc = ClusteringService({workdir!r}, max_batch=1, max_wait_s=0.0,
                        checkpoint_every=1, device="cpu")
client = MiningClient(service=svc)
svc.start()
h = client.submit("t0", "dbscan", x, params={{"eps": 0.6, "min_pts": 4}},
                  executor="torch-ref")
# signal readiness only once the announced execute span is ON DISK: the
# parent's SIGKILL must land after the first attempt's footprint exists
ev = os.path.join({workdir!r}, "events")
deadline = time.time() + 120
while time.time() < deadline:
    if any(s["name"] == "execute" for s in read_spans(ev, h.trace_id)):
        break
    time.sleep(0.005)
print("RUNNING", h.trace_id, flush=True)
h.result(600)
print("FINISHED", flush=True)
time.sleep(600)
"""


def test_sigkill_mid_execution_trace_survives(tmp_path):
    """A real kill -9 while a batch executes: the announced execute
    span_start from the dead process must survive on disk, and the fresh
    process's resume must extend the SAME trace with a resume marker and
    a completed second attempt."""
    workdir = str(tmp_path / "svc")
    script = _KILL_SCRIPT.format(src=SRC, workdir=workdir)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, text=True)
    trace_id, finished = None, False
    try:
        deadline = time.time() + 180
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("RUNNING"):
                trace_id = line.split()[1]
                break
            if not line:
                break
        child_pid = proc.pid
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.wait(30)
    assert trace_id, "child never reached execution"

    svc = ClusteringService(workdir, device="cpu")
    outcomes = svc.resume_suspended()
    spans = svc.export_trace(trace_id)
    svc.stop()
    assert spans and all(s["trace_id"] == trace_id for s in spans)
    pids = {s["pid"] for s in spans}
    assert child_pid in pids and os.getpid() in pids    # both lifetimes
    # the dead process's attempt left its footprint (announced span or
    # completed, depending on where the SIGKILL landed)
    child_exec = [s for s in spans
                  if s["name"] == "execute" and s["pid"] == child_pid]
    assert child_exec, "first execute attempt left no trace"
    if outcomes:       # kill landed mid-execution (the intended window)
        assert len(outcomes) == 1 and outcomes[0].resumed
        names = {s["name"] for s in spans if s["pid"] == os.getpid()}
        assert {"resume", "execute"} <= names
        second = [s for s in spans if s["name"] == "execute"
                  and s["pid"] == os.getpid()]
        assert any(s["attrs"].get("resumed") for s in second)
    # also on disk, independent of any in-memory ring
    disk = {s["name"] for s in read_spans(os.path.join(workdir, "events"),
                                          trace_id)}
    assert "wal_append" in disk and "execute" in disk


# -- cross-package -------------------------------------------------------------


def test_chrome_trace_and_slo_match_the_reference():
    tr = RequestTracer()
    t0 = time.time()
    tr.emit("t1", "execute", t0, 0.25, executor="torch-ref")
    tr.emit("t1", "deliver", t0 + 0.25, 0.001)
    spans = [s.as_dict() for s in tr.spans()]
    assert chrome_trace(spans) == jax_chrome_trace(spans)
    lat = [0.01] * 8 + [0.5, 0.5]
    kw = dict(latency_target_s=0.1, latency_percentile=90.0,
              error_rate_target=0.1)
    for failures, outcomes in ((0, 10), (1, 20), (5, 5)):
        assert (SLOEvaluator(**kw).evaluate(lat, failures=failures,
                                            outcomes=outcomes)
                == JaxSLOEvaluator(**kw).evaluate(lat, failures=failures,
                                                  outcomes=outcomes))


def test_exposition_of_the_ports_snapshot_passes_the_reference(tmp_path):
    """The port's live snapshot renders to the same text through either
    package's renderer, and both validators accept it."""
    svc = ClusteringService(str(tmp_path), max_batch=2, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc:
        hs = [client.submit(f"t{i}", "kmeans", pts(i),
                            params={"k": 3, "seed": i},
                            executor="torch-ref")
              for i in range(2)]
        for h in hs:
            h.result(300)
    snap = svc.metrics_snapshot()
    text = render_prometheus(snap)
    assert text == jax_render_prometheus(snap)
    assert exposition_errors(text) == jax_exposition_errors(text) == []
    for bad in ("repro_x{bad 1.0\n", "orphan_sample 1.0\n"):
        assert exposition_errors(bad) == jax_exposition_errors(bad) != []


# -- metrics snapshot integration ---------------------------------------------


def test_snapshot_has_stage_breakdown_and_host_device_split(tmp_path):
    svc = ClusteringService(str(tmp_path), max_batch=4, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc:
        hs = [client.submit(f"t{i}", "kmeans", pts(20 + i),
                            params={"k": 3, "seed": i},
                            executor="torch-ref")
              for i in range(4)]
        for h in hs:
            h.result(300)
    snap = svc.metrics_snapshot()
    assert {"execute", "wal_append", "queue_wait",
            "deliver"} <= set(snap["stages"])
    ex = snap["by_executor"]["torch-ref"]
    assert ex["host_s"] > 0.0 and ex["device_s"] > 0.0
    assert ex["host_s"] + ex["device_s"] == pytest.approx(ex["exec_s"])
    assert snap["slo"]["window_requests"] == 4
    assert snap["trace"]["dropped"] == 0
    assert snap["events"]["written"] > 0
