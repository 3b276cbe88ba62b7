"""The port's durable admission log against the reference's WAL tests.

The twin of ``tests/test_wal.py``, on the CPU: WAL append/replay/
compaction semantics, crash recovery (including a real SIGKILL between
admission and batching, through the port's service on ``device="cpu"``),
and the queue-fairness / retry_after / shared-exception / token-bucket
regressions.  A parity case writes the same log through both packages:
the segment files are byte-identical and each package replays the
other's.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from repro.service.wal import RequestLog as JaxRequestLog
from repro_torch.service import (
    AdmissionQueue,
    ClusteringService,
    MiningClient,
    RateLimited,
    RequestLog,
    content_key,
)
from repro_torch.service.faults import read_ledger
from repro_torch.service.queue import MiningRequest
from repro_torch.service.wal import _FRAME

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def pts(seed, n=48, d=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20.0, 20.0, size=(3, d)).astype(np.float32)
    return np.concatenate([
        c + rng.normal(0.0, 0.5, size=(n // 3, d)).astype(np.float32)
        for c in centers
    ])


def admit(log, i, tenant=None):
    return log.append_admit(
        tenant or f"t{i % 3}", "kmeans", pts(i),
        {"k": 3, "seed": i}, cache_key=f"ck{i}")


# -- RequestLog unit -----------------------------------------------------------


def test_wal_append_replay_roundtrip(tmp_path):
    log = RequestLog(str(tmp_path))
    data = pts(0)
    eid = log.append_admit("alice", "kmeans", data,
                           {"k": 3, "seed": 7}, executor="torch-ref",
                           priority=0, deadline=123.5, cache_key="ck")
    (rec,) = log.replay()
    assert rec.entry_id == eid
    assert rec.tenant == "alice" and rec.algo == "kmeans"
    assert rec.params == {"k": 3, "seed": 7}
    assert rec.executor == "torch-ref" and rec.priority == 0
    assert rec.deadline == 123.5 and rec.cache_key == "ck"
    assert rec.data.dtype == np.float32 and (rec.data == data).all()


def test_wal_consumed_entries_do_not_replay(tmp_path):
    log = RequestLog(str(tmp_path))
    ids = [admit(log, i) for i in range(5)]
    log.mark_consumed(ids[1:3], job_id=9)
    assert [r.entry_id for r in log.replay()] == [ids[0], ids[3], ids[4]]
    # idempotent: re-consuming already-consumed ids appends nothing
    before = log.stats()["fsyncs"]
    log.mark_consumed(ids[1:3])
    assert log.stats()["fsyncs"] == before


def test_wal_reopen_preserves_pending_and_entry_ids(tmp_path):
    log = RequestLog(str(tmp_path))
    ids = [admit(log, i) for i in range(4)]
    log.mark_consumed(ids[:2])
    log.close()
    log2 = RequestLog(str(tmp_path))
    assert [r.entry_id for r in log2.replay()] == ids[2:]
    nid = admit(log2, 99)
    assert nid > max(ids)          # ids stay monotonic across reopens
    assert [r.entry_id for r in log2.replay()] == ids[2:] + [nid]


def test_wal_segment_rotation_and_compaction(tmp_path):
    # tiny segments force rotation every couple of entries
    log = RequestLog(str(tmp_path), segment_bytes=2048)
    ids = [admit(log, i) for i in range(12)]
    assert log.stats()["segments"] > 2
    # nothing consumed: compaction must drop nothing
    assert log.compact() == 0
    # consume everything but the newest entry: every sealed segment before
    # the one holding it becomes droppable — mark_consumed compacts
    # opportunistically, so the prefix is reclaimed without an explicit
    # compact() call
    log.mark_consumed(ids[:-1])
    log.compact()
    assert log.stats()["compacted_segments"] > 0
    assert [r.entry_id for r in log.replay()] == [ids[-1]]
    # a consumed-but-live-segment entry stays readable until its segment goes
    log.mark_consumed([ids[-1]])
    log.compact()
    assert log.replay() == []
    assert log.pending() == 0


def test_wal_ids_not_reissued_after_compaction_and_reopen(tmp_path):
    """Regression: compaction can drop the segments holding every ADMIT
    while their CONSUME markers survive in a later segment; a reopen must
    still never reissue those entry ids, or the stale markers would
    silently swallow the new admits at replay."""
    log = RequestLog(str(tmp_path), segment_bytes=2048)
    ids = [admit(log, i) for i in range(12)]
    log.mark_consumed(ids)         # opportunistic compaction drops admits
    log.compact()
    log.close()
    log2 = RequestLog(str(tmp_path))
    nid = admit(log2, 77)
    assert nid > max(ids)          # id space advanced past consumed ids
    assert [r.entry_id for r in log2.replay()] == [nid]


def test_wal_failed_write_does_not_hide_later_appends(tmp_path):
    """Regression: a failed mid-record write must not leave torn bytes in
    the middle of the segment — later fsync-acknowledged appends would
    sit behind an unreadable frame, invisible to replay and permanently
    truncated by the next open."""
    log = RequestLog(str(tmp_path))
    i1 = admit(log, 1)
    real_write = log._file.write
    calls = []

    def flaky(b):
        calls.append(1)
        if len(calls) == 2:        # die after the frame, mid-record
            raise OSError("disk hiccup")
        return real_write(b)

    log._file.write = flaky
    with pytest.raises(OSError):
        admit(log, 2)
    # the repair cut the segment back to the last record boundary, so the
    # next append is fully readable, in-process and after reopen
    i3 = admit(log, 3)
    assert [r.entry_id for r in log.replay()] == [i1, i3]
    log.close()
    log2 = RequestLog(str(tmp_path))
    assert [r.entry_id for r in log2.replay()] == [i1, i3]


def test_wal_corrupt_tail_truncated_crc(tmp_path):
    log = RequestLog(str(tmp_path), segment_bytes=1 << 20)
    ids = [admit(log, i) for i in range(3)]
    log.close()
    (seg,) = [f for f in os.listdir(tmp_path) if f.endswith(".log")]
    path = os.path.join(tmp_path, seg)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 11)      # tear the last record mid-CRC/payload
    log2 = RequestLog(str(tmp_path))
    # everything before the torn record replays; the tear is dropped
    assert [r.entry_id for r in log2.replay()] == ids[:2]
    # and the log keeps working: the torn bytes were truncated, so new
    # appends land on a clean tail that readers can actually reach
    nid = admit(log2, 50)
    assert [r.entry_id for r in log2.replay()] == ids[:2] + [nid]


def test_wal_corrupt_record_drops_segment_tail_only(tmp_path):
    log = RequestLog(str(tmp_path), segment_bytes=1200)
    ids = [admit(log, i) for i in range(8)]
    log.close()
    segs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".log"))
    assert len(segs) >= 3
    # flip a byte in the FIRST record of a middle segment: that segment's
    # records are untrusted from the flip on, later segments still replay
    victim = os.path.join(tmp_path, segs[1])
    with open(victim, "r+b") as f:
        f.seek(_FRAME.size + 4)
        b = f.read(1)
        f.seek(_FRAME.size + 4)
        f.write(bytes([b[0] ^ 0xFF]))
    log2 = RequestLog(str(tmp_path))
    replayed = {r.entry_id for r in log2.replay()}
    assert replayed < set(ids)            # the damaged segment lost entries
    first_seg_ids = {r.entry_id
                     for r in log2.replay() if r.entry_id == ids[0]}
    assert first_seg_ids == {ids[0]}      # earlier segment intact
    assert max(replayed) == ids[-1]       # later segments intact


# -- service crash recovery ----------------------------------------------------


def test_crash_before_batching_replays_everything(tmp_path):
    """Admitted-but-unbatched requests survive process death: a service
    that never ran its dispatcher 'crashes' (objects dropped, queue dies
    in memory) and a fresh service over the workdir replays all of them."""
    wd = str(tmp_path / "svc")
    svc = ClusteringService(wd, max_batch=64, max_wait_s=3600.0, device="cpu")
    client = MiningClient(service=svc)
    keys = []
    for i in range(3):
        h = client.submit(f"t{i}", "kmeans", pts(i),
                          params={"k": 3, "seed": i}, executor="torch-ref")
        keys.append(h.cache_key)
    assert svc.wal.pending() == 3
    del svc, client                      # crash: nothing stopped cleanly

    svc2 = ClusteringService(wd, max_batch=4, max_wait_s=0.005, device="cpu")
    client2 = MiningClient(service=svc2)
    with svc2:
        summary = client2.recover()
        assert summary["resumed_batches"] == 0
        assert summary["replayed"] == 3 and summary["rejected"] == 0
        results = [h.result(120) for h in summary["requests"]]
    assert [h.cache_key for h in summary["requests"]] == keys
    assert all(r["labels"].shape == (48,) for r in results)
    assert svc2.wal.pending() == 0       # replays consumed their entries


def test_replay_equivalence_vs_uninterrupted_run(tmp_path):
    """Crash-then-recover must produce exactly the labels an uninterrupted
    service produces for the same requests."""
    ref_labels = {}
    svc = ClusteringService(str(tmp_path / "ref"), max_batch=4,
                            max_wait_s=0.005, device="cpu")
    client = MiningClient(service=svc)
    with svc:
        for i in range(3):
            h = client.submit(f"t{i}", "kmeans", pts(i),
                              params={"k": 3, "seed": i},
                              executor="torch-ref")
            ref_labels[h.cache_key] = h.result(120)["labels"]

    wd = str(tmp_path / "crash")
    svc1 = ClusteringService(wd, max_batch=64, max_wait_s=3600.0, device="cpu")
    c1 = MiningClient(service=svc1)
    for i in range(3):
        c1.submit(f"t{i}", "kmeans", pts(i), params={"k": 3, "seed": i},
                  executor="torch-ref")
    del svc1, c1

    svc2 = ClusteringService(wd, max_batch=4, max_wait_s=0.005, device="cpu")
    c2 = MiningClient(service=svc2)
    with svc2:
        summary = c2.recover()
        for h in summary["requests"]:
            assert (h.result(120)["labels"] == ref_labels[h.cache_key]).all()


def test_replay_dedup_via_result_cache(tmp_path):
    """A WAL entry whose content already completed (spilled result cache)
    replays for free: cache hit, no recompute, entry consumed."""
    wd = str(tmp_path / "svc")
    data = pts(4)
    params = {"k": 3, "seed": 4}
    svc = ClusteringService(wd, max_batch=1, max_wait_s=0.0, device="cpu")
    client = MiningClient(service=svc)
    with svc:
        client.submit("t0", "kmeans", data, params=params,
                      executor="torch-ref").result(120)
    # simulate a crash that left an unconsumed entry for the same content
    svc.wal.append_admit("t0", "kmeans", data, params,
                         executor="torch-ref",
                         cache_key=content_key("kmeans", params, data))
    svc2 = ClusteringService(wd, max_batch=1, max_wait_s=0.0, device="cpu")
    c2 = MiningClient(service=svc2)
    with svc2:
        summary = c2.recover()
        assert summary["replayed"] == 1
        assert summary["cache_hits"] == 1          # no device work
        (h,) = summary["requests"]
        assert h.done() and h.result(1)["labels"].shape == (48,)
    assert svc2.wal.pending() == 0


def test_submit_rejects_params_that_cannot_replay(tmp_path):
    """A tuple param value is hashable (passes the batch-key gate) but
    degrades to a list through the WAL's JSON roundtrip, so replay would
    reject it after the caller was told 'admitted' — the door must refuse
    it synchronously instead."""
    svc = ClusteringService(str(tmp_path / "svc"), max_batch=4,
                            max_wait_s=0.005, device="cpu")
    client = MiningClient(service=svc)
    with pytest.raises(ValueError, match="JSON"):
        client.submit("t0", "kmeans", pts(0),
                      params={"k": 3, "seed": 0, "note": (1, 2)})
    assert svc.wal.pending() == 0        # nothing half-admitted


def test_completed_and_cancelled_requests_do_not_replay(tmp_path):
    """Consumption closes the loop at both ends: a batch-completed request
    (step-0 hook) and a cancelled one (done-callback) leave nothing for
    recover() to replay."""
    wd = str(tmp_path / "svc")
    svc = ClusteringService(wd, max_batch=1, max_wait_s=0.0, device="cpu")
    client = MiningClient(service=svc)
    with svc:
        client.submit("t0", "kmeans", pts(0), params={"k": 3, "seed": 0},
                      executor="torch-ref").result(120)
    assert svc.wal.pending() == 0        # consumed at step-0

    svc2 = ClusteringService(wd, max_batch=64, max_wait_s=3600.0, device="cpu")
    c2 = MiningClient(service=svc2)
    h = c2.submit("t0", "kmeans", pts(1), params={"k": 3, "seed": 1})
    assert svc2.wal.pending() == 1
    assert h.cancel()
    assert svc2.wal.pending() == 0       # consumed by the done-callback

    svc3 = ClusteringService(wd, max_batch=4, max_wait_s=0.005, device="cpu")
    c3 = MiningClient(service=svc3)
    with svc3:
        assert c3.recover()["replayed"] == 0


_KILL_SCRIPT = r"""
import sys
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.service import ClusteringService, MiningClient

rng = np.random.default_rng(31)
svc = ClusteringService({workdir!r}, max_batch=64, max_wait_s=3600.0,
                        device="cpu")
client = MiningClient(service=svc)
svc.start()                       # real dispatcher: requests reach staging
for i in range(3):
    centers = rng.uniform(-20.0, 20.0, size=(3, 2)).astype(np.float32)
    x = np.concatenate([c + rng.normal(0.0, 0.5, size=(16, 2))
                        .astype(np.float32) for c in centers])
    client.submit(f"t{{i}}", "kmeans", x, params={{"k": 3, "seed": i}},
                  executor="torch-ref")
print("SURVIVED", flush=True)     # unreachable: the 3rd append kills us
"""


def test_sigkill_between_admission_and_batching_replays(tmp_path):
    """A real SIGKILL after admission, before any batch forms: the WAL is
    the only survivor, and recover() replays every request.

    The kill is injected deterministically through the fault harness
    (``wal.append.after_fsync=kill@3``): the child dies inside its third
    ``append_admit``, *after* the fsync — all three admits are durable,
    none was batched, and the ledger proves exactly where it died.  This
    replaces the old racy parent-side ``kill -9`` window."""
    workdir = str(tmp_path / "svc")
    ledger = str(tmp_path / "faults.ledger")
    script = _KILL_SCRIPT.format(src=SRC, workdir=workdir)
    proc = subprocess.Popen(
        [sys.executable, "-c", script],
        env=dict(os.environ, REPRO_FAULT="wal.append.after_fsync=kill@3",
                 REPRO_FAULT_LEDGER=ledger),
        stdout=subprocess.PIPE, text=True)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == -signal.SIGKILL
    assert "SURVIVED" not in out
    assert {"point": "wal.append.after_fsync", "action": "kill",
            "hit": 3} in [
        {k: e[k] for k in ("point", "action", "hit")}
        for e in read_ledger(ledger)]

    svc = ClusteringService(workdir, max_batch=4, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc:
        summary = client.recover()
        assert summary["replayed"] == 3
        for h in summary["requests"]:
            assert h.result(120)["labels"].shape == (48,)
    assert svc.wal.pending() == 0


# -- satellite bugfix regressions ----------------------------------------------


def kreq(tenant, seed=0):
    return MiningRequest(tenant=tenant, algo="kmeans", data=pts(seed),
                         params={"k": 3, "seed": seed})


def test_drain_limit_pressure_rotates_past_served_tenants():
    """Regression: drain(limit=...) used to rotate the tenant order only
    when a rotation completed without hitting the limit, so tenants early
    in insertion order were systematically favoured under pressure."""
    q = AdmissionQueue()
    for tenant in ("a", "b", "c"):
        for i in range(2):
            q.submit(kreq(tenant, seed=i))
    first = [r.tenant for r in q.drain(limit=2)]
    second = [r.tenant for r in q.drain(limit=2)]
    third = [r.tenant for r in q.drain(limit=2)]
    assert first == ["a", "b"]
    # the old code restarted every drain at "a": second == ["a", "b"] and
    # "c" starved until a/b emptied.  Fixed: the rotation resumes where
    # the limit cut it off.
    assert second == ["c", "a"]
    assert third == ["b", "c"]


def test_drain_rate_survives_idle_gap():
    """Regression: the first drain after a quiet spell divided by the
    whole idle period, cratering the EWMA and inflating retry_after."""
    q = AdmissionQueue()
    t0 = 1000.0
    for i in range(4):
        q.submit(kreq("t", seed=i))
    q.drain(limit=2, now=t0)
    q.drain(limit=2, now=t0 + 0.5)       # 2 per 0.5s => 4/s
    rate_before = q._drain_rate
    assert rate_before > 0
    # a long idle gap of empty polls, then traffic returns
    q.drain(now=t0 + 100.0)              # empty drain
    for i in range(4):
        q.submit(kreq("t", seed=i + 10))
    q.drain(limit=4, now=t0 + 100.01)
    # old code: dt spanned the 99.5s gap -> inst ~0.04/s -> EWMA craters
    # and retry_after overestimates ~25x.  Fixed: empty drains reset the
    # inter-drain clock, so the rate reflects actual drain throughput.
    assert q._drain_rate >= rate_before
    assert q._retry_after(4) <= 4 / rate_before + 0.01


def test_batch_failure_gives_each_request_its_own_exception(tmp_path):
    """Regression: every request of a failed batch was failed with the
    SAME exception instance; concurrent wait() callers then re-raised one
    shared object, racing on its __traceback__."""
    svc = ClusteringService(str(tmp_path), max_batch=4, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)

    def boom(*a, **k):
        raise ValueError("kernel exploded")

    svc.executor.run_batch = boom
    with svc:
        handles = [
            client.submit("t0", "kmeans", pts(9), params={"k": 3, "seed": i},
                          executor="torch-ref")
            for i in range(3)
        ]
        errors = [h.exception(30) for h in handles]
    assert all(isinstance(e, ValueError) for e in errors)
    assert len({id(e) for e in errors}) == 3        # distinct instances
    # each per-request copy chains to an original failure (one original
    # per batch; timing decides how the 3 requests coalesce)
    assert all(isinstance(e.__cause__, ValueError) for e in errors)
    assert all(e.__cause__ is not e for e in errors)


def test_token_bucket_ignores_backwards_clock():
    """Regression: a backwards wall-clock step made the refill delta
    negative, DRAINING tokens instead of refilling none."""
    q = AdmissionQueue(tenant_rate=1.0, tenant_burst=4)
    q._take_token("t", now=100.0)
    q._take_token("t", now=100.0)
    assert q._buckets["t"][0] == pytest.approx(2.0)
    # clock steps back 50s: must refill nothing and must not drain
    q._take_token("t", now=50.0)
    assert q._buckets["t"][0] == pytest.approx(1.0)
    # and the rewound span is not re-credited when the clock catches up
    q._take_token("t", now=100.0)
    assert q._buckets["t"][0] == pytest.approx(0.0)
    with pytest.raises(RateLimited) as ei:
        q._take_token("t", now=100.0)
    assert ei.value.retry_after == pytest.approx(1.0)


# -- parity with the reference package ---------------------------------------


def _same_ops(log):
    """Appends, consumes and compactions over rotating segments."""
    ids = [admit(log, i) for i in range(10)]
    log.mark_consumed(ids[:3], job_id=1)
    log.mark_consumed(ids[5:7], job_id=2)
    log.compact()
    ids.append(admit(log, 10))
    log.mark_consumed(ids[3:5])
    log.compact()
    return ids


def _segments(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root)) if name.endswith(".log")}


def test_wal_segments_are_byte_identical_to_the_reference(tmp_path):
    ours = RequestLog(str(tmp_path / "ours"), segment_bytes=2048)
    theirs = JaxRequestLog(str(tmp_path / "theirs"), segment_bytes=2048)
    assert _same_ops(ours) == _same_ops(theirs)
    assert ours.stats()["compacted_segments"] > 0
    assert _segments(ours.root) == _segments(theirs.root)
    assert ([r.entry_id for r in ours.replay()]
            == [r.entry_id for r in theirs.replay()])
    ours.close()
    theirs.close()

    # each package replays the other's log, payloads and all
    for mine, other in ((RequestLog(theirs.root), JaxRequestLog(ours.root)),
                        (JaxRequestLog(theirs.root), RequestLog(ours.root))):
        a, b = mine.replay(), other.replay()
        assert [r.entry_id for r in a] == [r.entry_id for r in b]
        for ra, rb in zip(a, b):
            assert (ra.tenant, ra.algo, ra.params, ra.cache_key) == (
                rb.tenant, rb.algo, rb.params, rb.cache_key)
            assert ra.data.dtype == rb.data.dtype
            np.testing.assert_array_equal(ra.data, rb.data)
        # and appending goes on where the other package left off
        assert admit(mine, 50) == admit(other, 50)
        mine.close()
        other.close()
