"""The port's zero-downtime tier against the reference's tests, on the CPU.

The twin of ``tests/test_replication.py``: WAL shipping to a warm standby,
lag/health, promotion (``promote(device="cpu")``), in-process handover,
and live config reload.  A parity case ships a WAL written by the
reference package to the port's standby and back.
"""

import http.client
import json
import os
import time

import numpy as np
import pytest

from repro.service import replicate as jax_replicate
from repro.service.wal import RequestLog as JaxRequestLog
from repro_torch.service import (
    ClusteringService,
    MiningClient,
    StandbyReplica,
    WalShipper,
)
from repro_torch.service.queue import BacklogFull
from repro_torch.service.telemetry import exposition_errors, render_prometheus
from repro_torch.service.wal import RequestLog

KM_PARAMS = {"k": 2, "max_iters": 5}


def blob(seed, clusters=2, points=16, features=2):
    """Gaussian blobs made with numpy, so both packages see the same data."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(clusters, features))
    return np.concatenate([c + rng.normal(0.0, 0.5, size=(points, features))
                           for c in centers]).astype(np.float32)


def _admit(log, i):
    return log.append_admit("t0", "kmeans", blob(i),
                            dict(KM_PARAMS, seed=i))


def _http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _read_segments(root):
    out = {}
    for name in sorted(os.listdir(root)):
        if name.startswith("wal-"):
            with open(os.path.join(root, name), "rb") as f:
                out[name] = f.read()
    return out


# -- shipping ------------------------------------------------------------------


def test_ship_mirrors_bytes_and_clears_lag(tmp_path):
    log = RequestLog(str(tmp_path / "wal"), segment_bytes=2048)
    ids = [_admit(log, i) for i in range(5)]
    standby = StandbyReplica(str(tmp_path / "standby")).start()
    try:
        shipper = WalShipper(log, "127.0.0.1", standby.port,
                             chunk_bytes=512)
        summary = shipper.ship_once()
        assert summary["chunks"] > 0
        # the mirror is the primary, byte for byte
        assert _read_segments(standby.wal_root) == _read_segments(log.root)
        snap = standby.stats()
        assert snap["applied_entry_id"] == ids[-1]
        assert snap["lag_entries"] == 0
        assert snap["pending_entries"] == len(ids)
        assert snap["apply_errors"] == 0
        st = shipper.stats()
        assert st["standby_lag_entries"] == 0
        assert st["bytes_shipped"] == sum(
            len(b) for b in _read_segments(log.root).values())
        # the watermark tracks new appends across cycles
        more = _admit(log, 99)
        shipper.ship_once()
        assert standby.stats()["applied_entry_id"] == more
    finally:
        standby.stop()
        log.close()


def test_retire_mirrors_compaction(tmp_path):
    # tiny segments: each admit seals the previous segment
    log = RequestLog(str(tmp_path / "wal"), segment_bytes=64)
    ids = [_admit(log, i) for i in range(4)]
    standby = StandbyReplica(str(tmp_path / "standby")).start()
    try:
        shipper = WalShipper(log, "127.0.0.1", standby.port)
        shipper.ship_once()
        before = len(_read_segments(standby.wal_root))
        assert before >= 2
        log.mark_consumed(ids)
        log.compact()
        shipper.ship_once()
        # the standby dropped exactly the prefix the primary compacted
        assert (sorted(_read_segments(standby.wal_root))
                == sorted(_read_segments(log.root)))
        assert standby.stats()["retired_segments"] >= 1
        assert shipper.stats()["retires_shipped"] >= 1
    finally:
        standby.stop()
        log.close()


def test_duplicate_chunk_resyncs_to_standby_offset(tmp_path):
    log = RequestLog(str(tmp_path / "wal"), segment_bytes=1 << 20)
    _admit(log, 0)
    standby = StandbyReplica(str(tmp_path / "standby")).start()
    try:
        shipper = WalShipper(log, "127.0.0.1", standby.port)
        shipper.ship_once()
        mirrored = _read_segments(standby.wal_root)
        (seq,) = shipper._cursor
        size = shipper._cursor[seq]
        # a restarted shipper re-sends from zero: the standby refuses the
        # duplicate and reports where the mirror really ends
        shipper._cursor[seq] = 0
        shipper.ship_once()
        assert shipper._cursor[seq] == size
        assert _read_segments(standby.wal_root) == mirrored  # no double write
        assert standby.stats()["apply_errors"] == 0
    finally:
        standby.stop()
        log.close()


# -- health + exposition -------------------------------------------------------


def test_standby_endpoints_and_exposition(tmp_path):
    standby = StandbyReplica(str(tmp_path / "standby")).start()
    try:
        status, body = _http_get(standby.port, "/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
        status, text = _http_get(standby.port, "/metrics")
        assert status == 200
        assert "repro_replica_lag_entries" in text
        assert "repro_replica_ok" in text
        assert exposition_errors(text) == []
        status, body = _http_get(standby.port, "/snapshot")
        assert status == 200 and "applies" in json.loads(body)
        assert _http_get(standby.port, "/nope")[0] == 404
    finally:
        standby.stop()


def test_stale_standby_reports_unhealthy(tmp_path):
    standby = StandbyReplica(str(tmp_path / "standby"),
                             max_lag_s=0.05).start()
    try:
        # a watermark with no applied bytes behind it: infinitely stale
        standby._apply({"op": "retire", "live_segments": [],
                        "watermark": {"last_entry_id": 99}}, b"")
        health = standby.health()
        assert health["ok"] is False and health["lag_entries"] == 99
        assert _http_get(standby.port, "/healthz")[0] == 503
        # the exposition stays parseable while unhealthy (inf lag and all)
        text = standby.render_prometheus()
        assert exposition_errors(text) == []
        assert "repro_replica_ok 0" in text
    finally:
        standby.stop()


# -- promotion -----------------------------------------------------------------


def test_promote_replays_pending_through_recover(tmp_path):
    log = RequestLog(str(tmp_path / "wal"), segment_bytes=1 << 20)
    ids = [_admit(log, i) for i in range(3)]
    standby = StandbyReplica(str(tmp_path / "standby"))
    standby.start()
    shipper = WalShipper(log, "127.0.0.1", standby.port)
    shipper.ship_once()
    log.close()                       # primary is gone

    svc, summary = standby.promote(max_batch=4, max_wait_s=0.02,
                                   cache_entries=8, device="cpu")
    try:
        assert standby.promoted
        assert standby.health()["ok"] is False   # not a target anymore
        assert summary["replayed"] == len(ids)
        deadline = time.time() + 60
        while svc.wal.pending() and time.time() < deadline:
            time.sleep(0.05)
        assert svc.wal.pending() == 0   # every admitted request ran
    finally:
        svc.stop(drain=True)


# -- primary-side metrics ------------------------------------------------------


def test_replication_block_in_snapshot_and_rendering(tmp_path):
    svc = ClusteringService(str(tmp_path / "svc"), max_batch=2,
                            max_wait_s=0.02, cache_entries=8, device="cpu")
    standby = StandbyReplica(str(tmp_path / "standby")).start()
    client = MiningClient(service=svc)
    try:
        with svc:
            shipper = WalShipper(svc.wal, "127.0.0.1", standby.port)
            svc.attach_replicator(shipper)
            h = client.submit("t0", "kmeans", blob(1),
                              params=dict(KM_PARAMS, seed=1))
            h.result(120)
            shipper.ship_once()
            snap = svc.metrics_snapshot()
            repl = snap["replication"]
            assert repl["bytes_shipped"] > 0
            assert repl["standby_lag_entries"] == 0
            assert repl["ship_errors"] == 0
            text = render_prometheus(snap)
            assert "repro_replication_bytes_shipped_total" in text
            assert "repro_replication_standby_lag_entries" in text
            assert "repro_config_epoch 0" in text
            assert exposition_errors(text) == []
    finally:
        standby.stop()


# -- in-process handover -------------------------------------------------------


def test_handover_successor_serves_predecessor_refuses(tmp_path):
    svc1 = ClusteringService(str(tmp_path / "svc"), max_batch=2,
                             max_wait_s=0.02, cache_entries=8, device="cpu")
    svc1.start()
    c1 = MiningClient(service=svc1)
    c1.submit("t0", "kmeans", blob(1),
              params=dict(KM_PARAMS, seed=1)).result(120)
    svc2 = svc1.handover()
    try:
        # the predecessor bounces with a RETRYABLE rejection (a router
        # would resubmit elsewhere), the successor serves
        with pytest.raises(BacklogFull):
            svc1.submit("t0", "kmeans", blob(2),
                        params=dict(KM_PARAMS, seed=2))
        h = MiningClient(service=svc2).submit(
            "t0", "kmeans", blob(3), params=dict(KM_PARAMS, seed=3))
        assert h.result(120)["algo"] == "kmeans"
        assert svc2.wal is not None and svc2.wal.pending() == 0
    finally:
        svc2.stop(drain=True)


# -- live reload ---------------------------------------------------------------


def test_live_reload_epoch_validation_and_effect(tmp_path):
    svc = ClusteringService(str(tmp_path / "svc"), max_batch=2,
                            max_wait_s=0.02, cache_entries=8,
                            tenant_rate=100.0, tenant_burst=50,
                            device="cpu")
    with svc:
        assert svc.config_epoch == 0
        cfg = svc.apply_config({"tenant_rate": 5.0, "tenant_burst": 9})
        assert cfg.epoch == 1 and svc.config_epoch == 1
        assert svc.queue.tenant_rate == 5.0
        assert svc.queue.tenant_burst == 9
        # a rejected reload changes NOTHING — not even the epoch
        with pytest.raises(ValueError):
            svc.apply_config({"tenant_rate": -1.0})
        with pytest.raises(ValueError):
            svc.apply_config({"no_such_knob": 1})
        with pytest.raises(ValueError, match="requires a restart"):
            svc.apply_config({"power_cap_watts": 5.0})   # built without pacer
        assert svc.config_epoch == 1
        assert svc.queue.tenant_rate == 5.0
        # bucket-policy swap lands in both the service and the batcher
        svc.apply_config({"bucket_policy": "linear:128"})
        assert svc.config_epoch == 2
        assert svc.batcher.policy is svc.bucket_policy
        assert svc.bucket_policy.snapshot()["name"] == "linear:128"
        snap = svc.metrics_snapshot()
        assert snap["config"]["epoch"] == 2
        assert "linear" in str(snap["config"]["bucket_policy"])


# -- the card is not optional --------------------------------------------------


def test_promote_without_a_card_raises(tmp_path):
    """``promote()`` asks for the card by default: on a host without one
    the service's constructor raises, and no CPU service starts."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the promotion would run on it")
    log = RequestLog(str(tmp_path / "wal"))
    _admit(log, 0)
    standby = StandbyReplica(str(tmp_path / "standby")).start()
    WalShipper(log, "127.0.0.1", standby.port).ship_once()
    log.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        standby.promote(max_batch=4)
    # the mirror is intact: a promotion on the host still replays it
    svc, summary = standby.promote(max_batch=4, device="cpu")
    try:
        assert summary["replayed"] == 1
    finally:
        svc.stop(drain=True)


# -- parity with the reference package ---------------------------------------


def test_reference_wal_ships_to_the_port_standby_and_back(tmp_path):
    """The mirror protocol is the file layout: the reference's shipper
    fills the port's standby with the reference's segments byte for byte,
    the port's shipper fills the reference's standby with the port's, and
    both standbys report the same watermark."""
    jlog = JaxRequestLog(str(tmp_path / "jwal"), segment_bytes=2048)
    plog = RequestLog(str(tmp_path / "pwal"), segment_bytes=2048)
    for i in range(5):
        _admit(jlog, i)
        _admit(plog, i)
    ours = StandbyReplica(str(tmp_path / "ours")).start()
    theirs = jax_replicate.StandbyReplica(str(tmp_path / "theirs")).start()
    try:
        jax_replicate.WalShipper(jlog, "127.0.0.1", ours.port,
                                 chunk_bytes=512).ship_once()
        WalShipper(plog, "127.0.0.1", theirs.port,
                   chunk_bytes=512).ship_once()
        assert _read_segments(ours.wal_root) == _read_segments(jlog.root)
        assert _read_segments(theirs.wal_root) == _read_segments(plog.root)
        a, b = ours.stats(), theirs.stats()
        for key in ("applied_entry_id", "lag_entries", "pending_entries",
                    "segments"):
            assert a[key] == b[key], key
    finally:
        ours.stop()
        theirs.stop()
        jlog.close()
        plog.close()
