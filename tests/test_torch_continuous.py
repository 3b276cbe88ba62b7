"""The reference's continuous (in-flight) batching tests
(``tests/test_continuous.py``) against the port's executor, with
``device="cpu"`` and the ``torch-ref`` lane (the reference's ``jax-ref``).
The file imports the port only: it is also the SIGKILLed child's script.
Reference labels come from the port's plain ``kmeans.fit_cancellable``
from the request's own seed.

Three behaviours carry the feature:
- early retirement: a converged item's future resolves the moment it
  finishes, not when the whole batch drains;
- mid-flight joins: a compatible queued request fills a freed padded slot
  of an in-flight batch (host-side data swap, same compiled program);
- crash durability: a join is persisted by the next periodic checkpoint,
  so a SIGKILL after that checkpoint replays BOTH the original and the
  joined request to labels identical to an uninterrupted core run.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import kmeans
from repro_torch.service.batcher import BatchKey, MicroBatch
from repro_torch.service.executor import BatchExecutor
from repro_torch.service.queue import MiningRequest

# shared batch params: every member of one continuous batch rides the same
# compiled program, so k/max_iters/tol are batch-level (seed is per-item)
K = 4
PARAMS = {"k": K, "max_iters": 300, "tol": 1e-6}


def _blobs(n, d, seed):
    """Tight, well-separated blobs: Lloyd converges in a handful of steps."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20.0, 20.0, size=(K, d))
    per = n // K
    x = np.concatenate([
        c + rng.normal(0.0, 0.05, size=(per, d)) for c in centers
    ]).astype(np.float32)
    rng.shuffle(x)
    return x


def _uniform(n, d, seed):
    """Structureless cloud: convergence takes many more iterations."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-5.0, 5.0, size=(n, d)).astype(np.float32)


def _request(tenant, x, seed):
    return MiningRequest(tenant, "kmeans", x, dict(PARAMS, seed=seed))


def _batch(requests, capacity):
    return MicroBatch(key=BatchKey.for_request(requests[0]),
                      requests=list(requests), capacity=capacity)


def _ref_labels(x, seed, max_iters=PARAMS["max_iters"], tol=PARAMS["tol"]):
    cfg = kmeans.KMeansConfig(k=K, max_iters=max_iters, tol=tol,
                              use_kernel=False)
    res = kmeans.fit_cancellable(seed, torch.from_numpy(np.asarray(x)), cfg)
    return res.labels.numpy()


def test_early_retire_resolves_before_batch_end(tmp_path):
    fast = _request("t-fast", _blobs(256, 2, seed=3), seed=3)
    slow = _request("t-slow", _uniform(256, 2, seed=4), seed=4)
    ex = BatchExecutor(str(tmp_path), checkpoint_every=4, device="cpu")

    retire_order = []

    def on_retire(req, result):
        # at the moment the fast item retires, the slow one must still be
        # in flight — that unresolved future is the whole point
        retire_order.append(
            (req.tenant, time.monotonic(),
             {r.tenant: r.done() for r in (fast, slow)}))
        req.resolve(result)

    outcome = ex.run_batch(
        _batch([fast, slow], capacity=4), executor="torch-ref",
        continuous=True, join_source=lambda free: [], on_retire=on_retire)

    assert outcome.continuous and not outcome.suspended
    assert outcome.retired == 2 and outcome.joined == 0
    assert [t for t, _, _ in retire_order] == ["t-fast", "t-slow"]
    _, t_fast, seen_at_fast = retire_order[0]
    _, t_slow, _ = retire_order[1]
    assert t_fast < t_slow
    assert seen_at_fast["t-slow"] is False    # slow future still pending
    assert fast.done() and slow.done()
    np.testing.assert_array_equal(fast.wait(1)["labels"],
                                  _ref_labels(fast.data, seed=3))
    np.testing.assert_array_equal(slow.wait(1)["labels"],
                                  _ref_labels(slow.data, seed=4))


def test_join_fills_freed_slot_without_recompile(tmp_path):
    first = _request("t-first", _uniform(256, 2, seed=5), seed=5)
    joiner = _request("t-join", _blobs(256, 2, seed=6), seed=6)
    ex = BatchExecutor(str(tmp_path), checkpoint_every=4, device="cpu")

    handed = []

    def join_source(free_slots):
        assert free_slots >= 1
        if not handed:
            handed.append(joiner)
            return [joiner]
        return []

    retired = []

    def on_retire(req, result):
        retired.append(req.tenant)
        req.resolve(result)

    outcome = ex.run_batch(
        _batch([first], capacity=2), executor="torch-ref",
        continuous=True, join_source=join_source, on_retire=on_retire)

    assert outcome.joined == 1 and outcome.retired == 2
    assert outcome.size == 2                       # both slots occupied
    assert set(outcome.request_ids) == {first.request_id, joiner.request_id}
    assert joiner.job_id == outcome.job_id          # swapped into the job
    assert sorted(retired) == ["t-first", "t-join"]
    np.testing.assert_array_equal(first.wait(1)["labels"],
                                  _ref_labels(first.data, seed=5))
    np.testing.assert_array_equal(joiner.wait(1)["labels"],
                                  _ref_labels(joiner.data, seed=6))


# -- join-after-checkpoint SIGKILL replay -------------------------------------

# the crash-replay batch runs to the iteration ceiling (tol=0 never
# converges): the child is guaranteed to be mid-flight when killed, and
# the reference run is exactly max_iters Lloyd steps for every member
_CRASH_PARAMS = {"k": K, "max_iters": 1200, "tol": 0.0}
_CRASH_N, _CRASH_D = 192, 2


def _crash_child(workdir: str) -> None:
    """Start a continuous batch, let one request join, checkpoint the
    join, signal readiness — then keep iterating until SIGKILLed."""
    first = MiningRequest("t-first", "kmeans",
                          _uniform(_CRASH_N, _CRASH_D, seed=21),
                          dict(_CRASH_PARAMS, seed=21))
    joiner = MiningRequest("t-join", "kmeans",
                           _uniform(_CRASH_N, _CRASH_D, seed=22),
                           dict(_CRASH_PARAMS, seed=22))
    # every event writes: the marker below must mean "the join is durable
    # on disk", so write coalescing is disabled for the crash run
    ex = BatchExecutor(workdir, checkpoint_every=2,
                       cont_save_interval_s=0.0, device="cpu")

    handed = []

    def join_source(free_slots):
        if not handed:
            handed.append(joiner)
            return [joiner]
        return []

    join_seen = [None]
    marker = os.path.join(workdir, "JOIN_CHECKPOINTED")

    def progress(job_id, item, events):
        if handed and join_seen[0] is None:
            join_seen[0] = events
        # a couple of post-join checkpoints have landed (each progress
        # event follows a completed save with coalescing off)
        if (join_seen[0] is not None and events >= join_seen[0] + 3
                and not os.path.exists(marker)):
            with open(marker, "w") as f:
                f.write(str(events))

    ex.run_batch(_batch([first], capacity=2), executor="torch-ref",
                 continuous=True, join_source=join_source,
                 progress_hook=progress,
                 on_retire=lambda req, result: req.resolve(result))


def test_join_survives_sigkill_and_replays(tmp_path):
    workdir = str(tmp_path / "svc")
    os.makedirs(workdir)
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.join(os.path.dirname(__file__), "..", "src")
        + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--continuous-child", workdir], env=env)
    marker = os.path.join(workdir, "JOIN_CHECKPOINTED")
    deadline = time.time() + 180
    try:
        while not os.path.exists(marker):
            assert proc.poll() is None, \
                f"crash child exited early (rc={proc.returncode})"
            assert time.time() < deadline, "child never checkpointed a join"
            time.sleep(0.02)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait(30)

    # the dead child's heartbeat must go stale before orphan recovery
    ex = BatchExecutor(workdir, heartbeat_timeout=0.2, device="cpu")
    time.sleep(1.5)
    outcomes = ex.resume_suspended()

    assert len(outcomes) == 1
    o = outcomes[0]
    assert o.resumed and not o.suspended
    assert o.size == 2, "the joined slot must survive the crash"
    assert sorted(o.tenants) == ["t-first", "t-join"]
    by_tenant = dict(zip(o.tenants, o.results))
    for tenant, seed in (("t-first", 21), ("t-join", 22)):
        ref = _ref_labels(_uniform(_CRASH_N, _CRASH_D, seed=seed),
                          seed=seed, max_iters=_CRASH_PARAMS["max_iters"],
                          tol=_CRASH_PARAMS["tol"])
        np.testing.assert_array_equal(
            by_tenant[tenant]["labels"], ref,
            err_msg=f"replayed labels diverged for {tenant}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--continuous-child":
        _crash_child(sys.argv[2])
    else:
        raise SystemExit(f"unknown child argv: {sys.argv[1:]}")
