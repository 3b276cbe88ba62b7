"""The port's fault-injection harness and crash matrix, on the CPU.

The twin of ``tests/test_faults.py``.  The matrix sweeps EVERY named
injection point of the port's ``faults.POINTS``:

- the four WAL points by real subprocess SIGKILLs, twice over: against a
  bare ``RequestLog`` (as the reference does), and against the port's
  ``ClusteringService`` on ``device="cpu"`` through each device lane
  (``cuda-kernel``, whose wrappers take their plain versions on the CPU,
  and ``torch-ref``) — after the kill a fresh service recovers the
  workdir and every request the child was told was admitted resolves
  with the labels an uninterrupted run gives;
- the three replication points by in-process ``raise`` faults: the
  shipper retries, the standby converges, and ``promote(device="cpu")``
  replays every admit through the lane it was admitted on, to the
  uninterrupted labels;
- the handover point the same way.

After each fault the invariant is the same: **no acknowledged admit is
lost**.  The coverage test requires the union of exercised points to
equal ``POINTS`` exactly, and a parity case requires ``POINTS`` to equal
the reference's.
"""

import contextlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.service import faults as jax_faults
from repro_torch.service import (
    ClusteringService,
    MiningClient,
    StandbyReplica,
    WalShipper,
    content_key,
    faults,
)
from repro_torch.service.faults import (
    POINTS,
    FaultInjected,
    parse_spec,
    read_ledger,
)
from repro_torch.service.fleet import rpc
from repro_torch.service.wal import RequestLog

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
LANES = ("cuda-kernel", "torch-ref")

# every point proven fired, across the whole matrix (ledger for kills,
# plan coverage for in-process raises) — asserted == POINTS at the end
EXERCISED = set()


@contextlib.contextmanager
def armed(spec, *, seed=None, ledger=None):
    """Arm ``spec`` in this process for a with-block, then disarm."""
    plan = faults.activate(spec, seed=seed, ledger=ledger)
    try:
        yield plan
    finally:
        faults.reset()


def child_env(spec, *, ledger=None):
    """Environment arming a subprocess with ``spec``."""
    env = dict(os.environ, REPRO_FAULT=spec, PYTHONPATH=SRC)
    env.pop("REPRO_FAULT_SEED", None)
    env.pop("REPRO_FAULT_LEDGER", None)
    if ledger is not None:
        env["REPRO_FAULT_LEDGER"] = ledger
    return env


def pts(seed, n=48, d=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20.0, 20.0, size=(3, d)).astype(np.float32)
    return np.concatenate([
        c + rng.normal(0.0, 0.5, size=(n // 3, d)).astype(np.float32)
        for c in centers
    ])


# the requests every lane-level scenario admits, and their content keys
N_REQ = 4
DATA = [pts(100 + i) for i in range(N_REQ)]
PARAMS = [{"k": 3, "seed": i, "max_iters": 20} for i in range(N_REQ)]
KEYS = [content_key("kmeans", p, d) for p, d in zip(PARAMS, DATA)]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Labels per content key of an uninterrupted run, per lane."""
    out = {}
    for lane in LANES:
        wd = str(tmp_path_factory.mktemp(f"ref-{lane}"))
        svc = ClusteringService(wd, max_batch=1, max_wait_s=0.0,
                                device="cpu")
        client = MiningClient(service=svc)
        with svc:
            handles = [client.submit("t0", "kmeans", d, params=p,
                                     executor=lane)
                       for d, p in zip(DATA, PARAMS)]
            out[lane] = {h.cache_key: h.result(120)["labels"]
                         for h in handles}
        assert sorted(out[lane]) == sorted(KEYS)
    return out


# -- harness unit --------------------------------------------------------------


def test_points_match_the_reference():
    assert POINTS == jax_faults.POINTS


def test_parse_spec_grammar():
    rules = parse_spec("wal.append.before_fsync=raise@3; "
                       "replicate.ship.before_send=delay:0.5; "
                       "wal.compact.before_unlink=kill")
    assert [(r.point, r.action, r.at_hit) for r in rules] == [
        ("wal.append.before_fsync", "raise", 3),
        ("replicate.ship.before_send", "delay", 1),
        ("wal.compact.before_unlink", "kill", 1),
    ]
    with pytest.raises(ValueError, match="unknown fault point"):
        parse_spec("no.such.point=raise")
    with pytest.raises(ValueError):
        parse_spec("wal.append.before_fsync")         # no action
    with pytest.raises(ValueError):
        parse_spec("wal.append.before_fsync=explode")  # bad action


def test_disarmed_points_are_noops():
    assert faults.active_plan() is None
    for point in POINTS:
        faults.at(point)                               # must not raise


def test_raise_fires_at_kth_hit_only():
    with armed("wal.append.before_fsync=raise@3") as plan:
        faults.at("wal.append.before_fsync")
        faults.at("wal.append.before_fsync")
        with pytest.raises(FaultInjected) as ei:
            faults.at("wal.append.before_fsync")
        assert ei.value.point == "wal.append.before_fsync"
        assert ei.value.hit == 3
        # later hits do not re-fire: @k is one-shot
        faults.at("wal.append.before_fsync")
        assert plan.hits["wal.append.before_fsync"] == 4
        assert plan.fired == {"wal.append.before_fsync"}


def test_delay_is_seeded_and_measurable():
    with armed("replicate.ship.before_send=delay:0.05"):
        t0 = time.monotonic()
        faults.at("replicate.ship.before_send")
        assert time.monotonic() - t0 >= 0.04
    # a jitter range draws from the seeded RNG: same seed, same delay
    draws = []
    for _ in range(2):
        with armed("replicate.ship.before_send=delay:0.0..0.05",
                   seed=42) as plan:
            faults.at("replicate.ship.before_send")
            (rule,) = plan.rules["replicate.ship.before_send"]
            draws.append(rule.last_delay_s)
    assert draws[0] == draws[1] and 0.0 <= draws[0] <= 0.05


def test_env_install_arms_subprocess(tmp_path):
    ledger = str(tmp_path / "led")
    script = ("import repro_torch.service.faults as f\n"
              "f.at('wal.compact.before_unlink')\n"
              "print('UNREACHED')\n")
    proc = subprocess.run(
        [sys.executable, "-c", script],
        env=child_env("wal.compact.before_unlink=kill", ledger=ledger),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL
    assert "UNREACHED" not in proc.stdout
    (entry,) = read_ledger(ledger)
    assert entry["point"] == "wal.compact.before_unlink"
    assert entry["action"] == "kill" and entry["hit"] == 1


# -- crash matrix: WAL points under real SIGKILL ------------------------------


_WAL_CHILD = r"""
import os
import numpy as np
from repro_torch.service.wal import RequestLog

ack = open({ack!r}, "a")
def note(tag, x):
    ack.write("%s %s\n" % (tag, x)); ack.flush(); os.fsync(ack.fileno())

log = RequestLog({root!r}, segment_bytes=512)
ids = []
for i in range(8):
    data = np.full((6, 2), float(i), dtype=np.float32)
    eid = log.append_admit("t%d" % (i % 2), "kmeans", data,
                           {{"k": 2, "seed": i}}, cache_key="ck%d" % i)
    ids.append(eid)
    note("ADMIT", eid)
log.mark_consumed(ids[:4], job_id=1)
for e in ids[:4]:
    note("CONSUME", e)
log.compact()
note("DONE", 0)
"""


def _run_wal_crash(tmp_path, spec):
    """Run the WAL workload child armed with ``spec``; return
    (acked admits, acked consumes, ledger entries, child returncode)."""
    root = str(tmp_path / "wal")
    ack = str(tmp_path / "acks")
    ledger = str(tmp_path / "ledger")
    script = _WAL_CHILD.format(root=root, ack=ack)
    proc = subprocess.run(
        [sys.executable, "-c", script],
        env=child_env(spec, ledger=ledger),
        capture_output=True, text=True, timeout=120)
    admits, consumes = set(), set()
    if os.path.exists(ack):
        with open(ack) as fh:
            for line in fh:
                tag, _, val = line.partition(" ")
                if tag == "ADMIT":
                    admits.add(int(val))
                elif tag == "CONSUME":
                    consumes.add(int(val))
    return root, admits, consumes, read_ledger(ledger), proc.returncode


_WAL_KILL_SPECS = [
    # die inside the 6th append, before its fsync: that admit was never
    # acknowledged, the five acknowledged ones must survive
    "wal.append.before_fsync=kill@6",
    # die inside the 6th append, after the fsync: durable but unacked —
    # the classic ack-lost window; at-least-once replay covers it
    "wal.append.after_fsync=kill@6",
    # die before the consume marker is appended: every admit must still
    # replay (consumption never became durable)
    "wal.mark_consumed.before_append=kill@1",
    # die inside compaction, before the first segment unlink (fires via
    # mark_consumed's opportunistic compact): reopen must stay coherent
    "wal.compact.before_unlink=kill@1",
]


@pytest.mark.parametrize("spec", _WAL_KILL_SPECS)
def test_crash_matrix_wal_kill_loses_no_acked_admit(tmp_path, spec):
    root, admits, consumes, ledger, rc = _run_wal_crash(tmp_path, spec)
    point = spec.split("=", 1)[0]
    assert rc == -signal.SIGKILL, f"child survived {spec}"
    assert any(e["point"] == point and e["action"] == "kill"
               for e in ledger), ledger
    EXERCISED.add(point)

    # the WAL is the only survivor: reopen and account for every ack
    log = RequestLog(root)
    try:
        pending = {r.entry_id for r in log.replay()}
        recovered = pending | set(log._consumed)
        lost = admits - recovered
        assert not lost, (f"{spec}: acked admits lost: {lost} "
                          f"(pending={pending})")
        # an admit whose consume never became durable must actually
        # replay — consumption is only real once its marker is on disk
        for eid in admits - set(log._consumed):
            assert eid in pending
        # and the log still works: a post-crash append is readable
        nid = log.append_admit("t9", "kmeans",
                               np.zeros((4, 2), dtype=np.float32),
                               {"k": 2, "seed": 99}, cache_key="ck99")
        assert nid in {r.entry_id for r in log.replay()}
    finally:
        log.close()


# -- crash matrix: WAL points under SIGKILL, through the service's lanes ------


_SERVICE_CHILD = r"""
import os
import numpy as np
from repro_torch.service import ClusteringService, MiningClient

data = np.load({data!r})
ack = open(os.path.join({acks!r}, "acks"), "a")
def note(tag, key):
    ack.write("%s %s\n" % (tag, key)); ack.flush(); os.fsync(ack.fileno())

# one request a batch, one WAL segment an admit: every request appends an
# admit and (at its batch's step 0) a consume, and every consume compacts
svc = ClusteringService({workdir!r}, max_batch=1, max_wait_s=0.0,
                        wal_segment_bytes=512, device="cpu").start()
client = MiningClient(service=svc)
for i in range({n}):
    h = client.submit("t0", "kmeans", data["x%d" % i],
                      params={{"k": 3, "seed": i, "max_iters": 20}},
                      executor={lane!r})
    note("ADMIT", h.cache_key)
    labels = h.result(120)["labels"]
    np.save(os.path.join({acks!r}, h.cache_key + ".npy"), labels)
    note("DONE", h.cache_key)
svc.stop()
print("SURVIVED", flush=True)
"""

# the k-th append of that workload: admit 1, consume 1, admit 2, ...
_SERVICE_KILL_SPECS = [
    "wal.append.before_fsync=kill@5",        # admit 3 written, not durable
    "wal.append.after_fsync=kill@5",         # admit 3 durable, unacked
    "wal.mark_consumed.before_append=kill@2",  # request 2 at step 0
    "wal.compact.before_unlink=kill@1",      # request 1 consumed, mid-run
]


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("spec", _SERVICE_KILL_SPECS)
def test_crash_matrix_service_kill_keeps_labels(tmp_path, spec, lane,
                                                uninterrupted):
    """SIGKILL the port's service at a WAL point mid-workload, recover a
    fresh service over the same workdir, and hold every acknowledged
    request and every replayed one to the uninterrupted labels."""
    workdir, acks = str(tmp_path / "svc"), str(tmp_path / "acks")
    os.makedirs(acks)
    data_path = str(tmp_path / "data.npz")
    np.savez(data_path, **{f"x{i}": d for i, d in enumerate(DATA)})
    ledger = str(tmp_path / "ledger")
    script = _SERVICE_CHILD.format(data=data_path, acks=acks,
                                   workdir=workdir, n=N_REQ, lane=lane)
    proc = subprocess.run([sys.executable, "-c", script],
                          env=child_env(spec, ledger=ledger),
                          capture_output=True, text=True, timeout=180)
    point = spec.split("=", 1)[0]
    assert proc.returncode == -signal.SIGKILL, (spec, proc.stderr[-2000:])
    assert "SURVIVED" not in proc.stdout
    assert any(e["point"] == point and e["action"] == "kill"
               for e in read_ledger(ledger))
    EXERCISED.add(point)
    acked, done = [], set()
    with open(os.path.join(acks, "acks")) as fh:
        for line in fh:
            tag, _, key = line.strip().partition(" ")
            (acked if tag == "ADMIT" else []).append(key)
            if tag == "DONE":
                done.add(key)
    assert acked, "the child was killed before its first admission"

    expected = uninterrupted[lane]
    svc = ClusteringService(workdir, max_batch=4, max_wait_s=0.005,
                            device="cpu")
    client = MiningClient(service=svc)
    with svc:
        summary = client.recover()
        for h in summary["requests"]:
            result = h.result(120)
            assert result["executor"] == lane
            np.testing.assert_array_equal(result["labels"],
                                          expected[h.cache_key])
        assert svc.wal.pending() == 0
        for key in acked:
            if key in done:
                labels = np.load(os.path.join(acks, key + ".npy"))
            else:
                # acknowledged but never delivered: the recovered service
                # holds it, replayed or resumed from its batch checkpoint
                cached = svc.cache.get(key)
                assert cached is not None, f"{spec}: acked {key} lost"
                labels = cached["labels"]
            np.testing.assert_array_equal(labels, expected[key])


# -- crash matrix: replication + handover points (in-process) -----------------


def _mk_wal(tmp_path, lane):
    """The lane-level requests, durably admitted to a primary's WAL."""
    log = RequestLog(str(tmp_path / "p"))
    ids = [log.append_admit("t0", "kmeans", d, p, executor=lane,
                            cache_key=k)
           for d, p, k in zip(DATA, PARAMS, KEYS)]
    return log, ids


def _promote_to_uninterrupted_labels(standby, lane, expected):
    """Promote the standby on the CPU: every mirrored admit replays on its
    lane to the uninterrupted labels."""
    svc, summary = standby.promote(device="cpu", max_batch=4,
                                   max_wait_s=0.005)
    try:
        assert summary["replayed"] == N_REQ
        for req in summary["requests"]:
            result = req.wait(120)
            assert result["executor"] == lane
            np.testing.assert_array_equal(result["labels"],
                                          expected[req.cache_key])
    finally:
        svc.stop(drain=True)


@pytest.mark.parametrize("lane", LANES)
def test_crash_matrix_ship_before_send(tmp_path, lane, uninterrupted):
    log, ids = _mk_wal(tmp_path, lane)
    standby = StandbyReplica(str(tmp_path / "s")).start()
    shipper = WalShipper(log, standby.host, standby.port)
    try:
        with armed("replicate.ship.before_send=raise@1") as plan:
            with pytest.raises(FaultInjected):
                shipper.ship_once()
            assert plan.fired == {"replicate.ship.before_send"}
        EXERCISED.add("replicate.ship.before_send")
        # disarmed retry converges: nothing admitted was lost
        shipper.ship_once()
        st = standby.stats()
        assert st["applied_entry_id"] == max(ids)
        assert st["pending_entries"] == len(ids)
    finally:
        log.close()
    _promote_to_uninterrupted_labels(standby, lane, uninterrupted[lane])


@pytest.mark.parametrize("lane", LANES)
def test_crash_matrix_ship_mid_segment(tmp_path, lane, uninterrupted):
    log, ids = _mk_wal(tmp_path, lane)
    standby = StandbyReplica(str(tmp_path / "s")).start()
    # small chunks force several sends per segment, so the second chunk
    # of the first segment runs with offset > 0
    shipper = WalShipper(log, standby.host, standby.port, chunk_bytes=256)
    try:
        with armed("replicate.ship.mid_segment=raise@1") as plan:
            with pytest.raises(FaultInjected):
                shipper.ship_once()
            assert plan.fired == {"replicate.ship.mid_segment"}
        EXERCISED.add("replicate.ship.mid_segment")
        # the standby holds a partial segment (possibly mid-frame); the
        # next cycle resumes from the byte cursor and converges
        shipper.ship_once()
        st = standby.stats()
        assert st["applied_entry_id"] == max(ids)
        assert st["lag_entries"] == 0
        assert st["crc_stalls"] >= 1      # the partial tail was observed
    finally:
        log.close()
    _promote_to_uninterrupted_labels(standby, lane, uninterrupted[lane])


@pytest.mark.parametrize("lane", LANES)
def test_crash_matrix_apply_before_write(tmp_path, lane, uninterrupted):
    log, ids = _mk_wal(tmp_path, lane)
    standby = StandbyReplica(str(tmp_path / "s")).start()
    shipper = WalShipper(log, standby.host, standby.port)
    try:
        # the standby's apply handler raises before touching its mirror:
        # the shipper sees a transport-level failure and keeps its cursor
        with armed("replicate.apply.before_write=raise@1") as plan:
            with pytest.raises(rpc.RpcError):
                shipper.ship_once()
            assert plan.fired == {"replicate.apply.before_write"}
        EXERCISED.add("replicate.apply.before_write")
        assert shipper.stats()["ship_errors"] >= 1
        assert standby.stats()["apply_errors"] >= 1
        shipper.ship_once()
        assert standby.stats()["applied_entry_id"] == max(ids)
    finally:
        log.close()
    _promote_to_uninterrupted_labels(standby, lane, uninterrupted[lane])


@pytest.mark.parametrize("lane", LANES)
def test_crash_matrix_handover_before_successor(tmp_path, lane,
                                                uninterrupted):
    wd = str(tmp_path / "svc")
    kw = dict(max_batch=1, max_wait_s=0.0, device="cpu")
    svc = ClusteringService(wd, **kw)
    client = MiningClient(service=svc)
    with svc:
        client.submit("t0", "kmeans", DATA[0], params=PARAMS[0],
                      executor=lane).result(120)
    # two unconsumed admits survive the stopped predecessor — the work a
    # successor must inherit
    for i in (1, 2):
        svc.wal.append_admit("t0", "kmeans", DATA[i], PARAMS[i],
                             executor=lane, cache_key=KEYS[i])

    svc2 = ClusteringService(wd, **kw).start()
    with armed("service.handover.before_successor=raise@1") as plan:
        with pytest.raises(FaultInjected):
            svc2.handover()
        assert plan.fired == {"service.handover.before_successor"}
    EXERCISED.add("service.handover.before_successor")
    # the predecessor is down and no successor was built — but nothing
    # is lost: the WAL holds the admits, and a retried handover (or any
    # fresh service over the workdir) replays them
    svc3 = svc2.handover()
    svc3.stop(drain=True)                   # runs both replays to the end
    assert svc3.wal.pending() == 0          # replay consumed both admits
    for i in (1, 2):
        np.testing.assert_array_equal(svc3.cache.get(KEYS[i])["labels"],
                                      uninterrupted[lane][KEYS[i]])


# -- the accounting ------------------------------------------------------------


def test_crash_matrix_covers_every_point():
    """Coverage accounting: the matrix above must have exercised every
    named injection point — the subprocess kills are proven by their
    ledgers, the in-process raises by the plan's fired set.  A point
    added to ``POINTS`` without a matrix scenario fails here."""
    missing = set(POINTS) - EXERCISED
    assert not missing, f"injection points never exercised: {missing}"
    assert EXERCISED == set(POINTS)
