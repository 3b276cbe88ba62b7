"""The reference's property-based tests (``tests/test_properties.py``)
against the port: the placement ring and WAL tail repair, plus two
cross-package properties (the same keys land on the same workers in both
packages' rings; a damaged segment written by the port repairs to the same
prefix when the reference reopens it).

Runs through ``_hypo_shim``: real Hypothesis when installed, otherwise a
seeded-random fallback with the same ``@given`` surface.  Each property
derives its randomness from a drawn ``seed`` so failures reproduce.
"""

import os
import random
import tempfile

import numpy as np
from _hypo_shim import HealthCheck, given, settings, strategies as st

from repro.service.fleet.hashring import (
    ConsistentHashRing as JaxConsistentHashRing,
)
from repro.service.wal import RequestLog as JaxRequestLog
from repro_torch.service.fleet.hashring import ConsistentHashRing
from repro_torch.service.wal import RequestLog

_HYPO = dict(
    deadline=None,
    max_examples=8,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)


def _ring(n, load_factor=1.25):
    return ConsistentHashRing([f"worker-{i}" for i in range(n)],
                              load_factor=load_factor)


def _segment(root):
    """The log's one segment.  (The reference's cases take the first name
    in the directory, which is its ``LOCK`` file, so they damage the lock
    and never the log; here the damage lands in the segment.)"""
    (name,) = [n for n in os.listdir(root) if n.endswith(".log")]
    return os.path.join(root, name)


def _keys(rng, count=40):
    return [f"tenant-{rng.randrange(10_000)}" for _ in range(count)]


# -- hashring: placement is total ----------------------------------------------


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 6))
def test_ring_placement_total(seed, n):
    """place() always lands on a live member, whatever the load shape."""
    rng = random.Random(seed)
    ring = _ring(n)
    loads = {node: rng.randrange(0, 20) for node in ring.nodes}
    for key in _keys(rng):
        node = ring.place(key, loads.get)
        assert node in ring.nodes
        assert ring.primary(key) in ring.nodes
        assert ring.preference(key)[0] == ring.primary(key)


# -- hashring: bounded-load capacity is respected ------------------------------


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 6),
       hot=st.booleans())
def test_ring_bounded_load_capacity(seed, n, hot):
    """A placed node is under ceil(c*(L+1)/n) — except the saturated-fleet
    fallback, which must then be the key's primary."""
    rng = random.Random(seed)
    ring = _ring(n)
    loads = {node: rng.randrange(0, 8) for node in ring.nodes}
    if hot:
        # saturate one node far past capacity: placements must spill
        loads[ring.nodes[0]] += 100
    total = sum(loads.values())
    cap = ring.capacity(total)
    for key in _keys(rng):
        node = ring.place(key, loads.get, total_load=total)
        if loads[node] >= cap:
            assert node == ring.primary(key)   # every member saturated
        else:
            assert loads[node] < cap


@settings(**_HYPO)
@given(total=st.integers(0, 10_000), n=st.integers(1, 12))
def test_ring_capacity_fits_one_request_on_idle_fleet(total, n):
    """capacity >= 1 always (the +1 in ceil(c*(L+1)/n)), so a request on
    an idle fleet is placeable on its primary."""
    ring = _ring(n)
    assert ring.capacity(total) >= 1
    assert ring.capacity(total) >= ring.capacity(0)


# -- hashring: minimal movement on join/leave ----------------------------------


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 5))
def test_ring_join_moves_keys_only_to_joiner(seed, n):
    rng = random.Random(seed)
    ring = _ring(n)
    keys = _keys(rng, count=60)
    before = {k: ring.primary(k) for k in keys}
    ring.add("worker-new")
    for k in keys:
        after = ring.primary(k)
        if after != before[k]:
            assert after == "worker-new"


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 6))
def test_ring_leave_moves_only_departed_keys(seed, n):
    rng = random.Random(seed)
    ring = _ring(n)
    keys = _keys(rng, count=60)
    gone = ring.nodes[rng.randrange(n)]
    before = {k: ring.primary(k) for k in keys}
    ring.remove(gone)
    for k in keys:
        after = ring.primary(k)
        if before[k] == gone:
            assert after != gone
        else:
            assert after == before[k]          # survivors keep their keys


# -- WAL: torn/corrupt tail repair ---------------------------------------------


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1), flip=st.booleans())
def test_wal_tail_damage_repairs_to_a_prefix(seed, flip):
    """Damage the segment at a random offset — truncation (torn append)
    or a byte flip (bit rot / partial sector) — and reopening must not
    raise, must replay an exact *prefix* of the original admits, and must
    accept + replay new appends after the repair."""
    rng = random.Random(seed)
    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "wal")
        log = RequestLog(root, segment_bytes=1 << 20)   # single segment
        ids = []
        for i in range(6):
            data = np.full((2, 2), float(i), dtype=np.float32)
            ids.append(log.append_admit("t0", "kmeans", data, {"k": 1}))
        log.close()

        seg = _segment(root)
        size = os.path.getsize(seg)
        offset = rng.randrange(size)
        if flip:
            with open(seg, "r+b") as f:
                f.seek(offset)
                b = f.read(1)
                f.seek(offset)
                f.write(bytes([b[0] ^ 0xFF]))
        else:
            with open(seg, "r+b") as f:
                f.truncate(offset)

        log2 = RequestLog(root, segment_bytes=1 << 20)  # repairs the tail
        try:
            replayed = [r.entry_id for r in log2.replay()]
            assert replayed == ids[:len(replayed)], (
                f"replay {replayed} is not a prefix of {ids} "
                f"(seed={seed} flip={flip} offset={offset})")
            # the repaired log must be appendable and the append visible
            new_id = log2.append_admit(
                "t0", "kmeans", np.ones((2, 2), dtype=np.float32), {"k": 1})
            assert new_id > (replayed[-1] if replayed else 0)
            after = [r.entry_id for r in log2.replay()]
            assert after == replayed + [new_id]
        finally:
            log2.close()


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1))
def test_wal_tail_repair_survives_a_reopen_cycle(seed):
    """Repair is durable: damage, reopen, close, reopen again — the
    second open sees the repaired prefix plus anything appended since."""
    rng = random.Random(seed)
    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "wal")
        log = RequestLog(root, segment_bytes=1 << 20)
        ids = [log.append_admit("t", "kmeans",
                                np.zeros((2, 2), dtype=np.float32), {"k": 1})
               for _ in range(4)]
        log.close()
        seg = _segment(root)
        with open(seg, "r+b") as f:
            f.truncate(rng.randrange(os.path.getsize(seg)))

        log2 = RequestLog(root, segment_bytes=1 << 20)
        survivors = [r.entry_id for r in log2.replay()]
        extra = log2.append_admit(
            "t", "kmeans", np.zeros((2, 2), dtype=np.float32), {"k": 1})
        log2.close()

        log3 = RequestLog(root, segment_bytes=1 << 20)
        try:
            assert [r.entry_id for r in log3.replay()] == survivors + [extra]
            assert survivors == ids[:len(survivors)]
        finally:
            log3.close()


# -- cross-package -------------------------------------------------------------


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 6),
       hot=st.booleans())
def test_ring_places_like_the_reference(seed, n, hot):
    """Same members, loads and keys: the same primary, preference list,
    capacity and bounded-load placement as the reference's ring."""
    rng = random.Random(seed)
    names = [f"worker-{i}" for i in range(n)]
    ring = ConsistentHashRing(names, load_factor=1.25)
    ref = JaxConsistentHashRing(names, load_factor=1.25)
    loads = {node: rng.randrange(0, 8) for node in names}
    if hot:
        loads[names[0]] += 100
    total = sum(loads.values())
    assert ring.capacity(total) == ref.capacity(total)
    for key in _keys(rng):
        assert ring.primary(key) == ref.primary(key)
        assert ring.preference(key) == ref.preference(key)
        assert (ring.place(key, loads.get, total_load=total)
                == ref.place(key, loads.get, total_load=total))


@settings(**_HYPO)
@given(seed=st.integers(0, 2**31 - 1), flip=st.booleans())
def test_wal_tail_repair_matches_the_reference(seed, flip):
    """A segment the port wrote, damaged at a random offset, replays to the
    same prefix of entries (ids, tenants, points) through either
    package's repair."""
    rng = random.Random(seed)
    with tempfile.TemporaryDirectory() as td:
        roots = [os.path.join(td, name) for name in ("port", "ref")]
        log = RequestLog(roots[0], segment_bytes=1 << 20)
        for i in range(6):
            data = np.full((2, 2), float(i), dtype=np.float32)
            log.append_admit(f"t{i}", "kmeans", data, {"k": 1})
        log.close()
        seg = _segment(roots[0])
        name = os.path.basename(seg)
        offset = rng.randrange(os.path.getsize(seg))
        with open(seg, "r+b") as f:
            if flip:
                f.seek(offset)
                b = f.read(1)
                f.seek(offset)
                f.write(bytes([b[0] ^ 0xFF]))
            else:
                f.truncate(offset)
        os.makedirs(roots[1])
        with open(seg, "rb") as f, \
                open(os.path.join(roots[1], name), "wb") as g:
            g.write(f.read())
        replays = []
        for cls, root in ((RequestLog, roots[0]), (JaxRequestLog, roots[1])):
            wal = cls(root, segment_bytes=1 << 20)
            try:
                replays.append([(r.entry_id, r.tenant,
                                 np.asarray(r.data).tolist())
                                for r in wal.replay()])
            finally:
                wal.close()
        assert replays[0] == replays[1], (seed, flip, offset)
