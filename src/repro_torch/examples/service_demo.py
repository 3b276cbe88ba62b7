"""Clustering-as-a-service tour: async client, QoS, lanes, streams, resume.

    PYTHONPATH=src python -m repro_torch.examples.service_demo
    PYTHONPATH=src python -m repro_torch.examples.service_demo --device cpu

The counterpart of the reference's ``examples/service_demo.py``; every
service and client runs on ``--device`` (the card by default).  Four acts:
1. two tenants submit mixed DBSCAN/K-Means requests through MiningClient;
   handles are futures (done()/result()/callbacks), compatible requests
   coalesce into padded micro-batches, and the executor pool runs lanes
   (cuda-kernel, torch-ref, numpy-mt) concurrently;
2. a repeated dataset hits the content-hash cache and skips compute;
3. a StreamingSession folds an unbounded point stream through mini-batch
   K-Means, checkpointing per-tenant model state — "killing" the session
   and reopening it resumes the centroids exactly;
4. the service is preempted mid-batch (the paper's activity-suspend), the
   in-flight batch checkpoints and parks SUSPENDED, and a *new* service
   instance resumes it to completion — the WorkManager reattach path.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import dbscan
from repro_torch.data.synthetic import ClusterSpec, make_blobs
from repro_torch.service import (
    PRIORITY_INTERACTIVE,
    ClusteringService,
    JobSuspended,
    MiningClient,
)

CFG = dbscan.DBSCANConfig.paper_defaults(2)
DBSCAN_PARAMS = {"eps": CFG.eps, "min_pts": CFG.min_pts}
STREAM = dict(tenant="alice", name="telemetry", k=3, batch_size=64)


def dataset(seed: int, clusters: int = 4, points: int = 64) -> np.ndarray:
    x, _, _ = make_blobs(seed, ClusterSpec(2, clusters, points))
    return x.numpy()


def serve_and_stream(workdir: str, device: str) -> dict:
    """Acts 1-3 on one client-owned service."""
    out: dict = {}
    # -- 1. async multi-tenant serving ---------------------------------------
    print("== async multi-tenant serving ==")
    with MiningClient(workdir=workdir, max_batch=4, max_wait_s=0.01,
                      device=device) as client:
        handles = []
        for i in range(4):
            tenant = ("alice", "bob")[i % 2]
            handles.append(client.submit(
                tenant, "dbscan", dataset(i), params=DBSCAN_PARAMS))
        # an interactive request rides the priority lane past the bulk work
        handles.append(client.submit(
            "alice", "kmeans", dataset(9), params={"k": 4, "seed": 9},
            priority=PRIORITY_INTERACTIVE, ttl=30.0))
        handles[0].add_done_callback(
            lambda h: print(f"  (callback) request {h.request_id} done"))
        out["results"] = []
        for h in handles:
            r = h.result(120)
            out["results"].append(r)
            desc = (f"{r['n_clusters']} clusters, {r['noise']} noise"
                    if r["algo"] == "dbscan"
                    else f"inertia {r['inertia']:.1f} in "
                         f"{r['iterations']} iters")
            print(f"  {h.tenant:5s} {r['algo']:6s} -> {desc}   "
                  f"[{r['executor']}, {1e3 * (h.latency or 0):.0f}ms]")

        # -- 2. content-hash cache --------------------------------------------
        repeat = client.submit("carol", "dbscan", dataset(0),
                               params=DBSCAN_PARAMS)
        repeat.result(10)
        out["cache_hit"] = repeat.cache_hit
        print(f"== cache == repeated dataset: hit={repeat.cache_hit} "
              f"({1e3 * (repeat.latency or 0):.2f}ms)")

        # -- 3. streaming session: checkpointed per-tenant model -------------
        print("== streaming ==")
        stream = client.stream(STREAM["tenant"], STREAM["name"],
                               k=STREAM["k"], batch_size=STREAM["batch_size"],
                               checkpoint_every=1)
        for i in range(4):
            stream.push(dataset(20 + i, clusters=3, points=48))
        snap = stream.snapshot()
        print(f"  stream step {snap['step']}, {snap['n_seen']} points "
              f"folded in")
        del stream  # 'SIGKILL': no close, no flush; the checkpoint survives
        resumed = client.stream(STREAM["tenant"], STREAM["name"],
                                k=STREAM["k"],
                                batch_size=STREAM["batch_size"])
        snap2 = resumed.snapshot()
        intact = bool(np.array_equal(snap["centroids"], snap2["centroids"]))
        print(f"  reopened stream at step {snap2['step']} "
              f"(centroids intact: "
              f"{np.allclose(snap['centroids'], snap2['centroids'])})")
        resumed.close()
        out.update(stream_before=snap, stream_after=snap2,
                   stream_intact=intact)
    out["lanes_acts_1_3"] = {
        name: st["batches"]
        for name, st in client.metrics()["lanes"].items() if st["batches"]}
    return out


def preempt_and_resume(workdir: str, device: str) -> dict:
    """Act 4: preempt mid-batch, resume in a fresh service."""
    print("== preemption ==")
    out: dict = {"resumed": []}
    svc2 = ClusteringService(workdir, max_batch=2, max_wait_s=0.0,
                             checkpoint_every=1, device=device).start()
    client2 = MiningClient(service=svc2)
    big = client2.submit("dave", "dbscan",
                         dataset(33, clusters=8, points=128),
                         params=DBSCAN_PARAMS, executor="torch-ref")
    # preempt almost immediately: the batch checkpoints and parks SUSPENDED
    time.sleep(0.3)
    svc2.stop(preempt=True)
    try:
        big.result(1)
        out["finished_first"] = True
        print("  (batch finished before the preemption landed — rerun to "
              "race)")
    except JobSuspended as e:
        out["finished_first"] = False
        print(f"  preempted: batch job {e.job_id} SUSPENDED with checkpoint")
        svc3 = ClusteringService(workdir, device=device)  # the 'restarted app'
        outcomes = svc3.resume_suspended()
        for o in outcomes:
            labels = o.results[0]["labels"]
            out["resumed"].append(o)
            print(f"  resumed job {o.job_id} on {o.executor}: "
                  f"{o.results[0]['n_clusters']} clusters over "
                  f"{len(labels)} pts")

    print("== metrics ==")
    snap = svc2.metrics_snapshot()
    lanes = {name: f"{st['busy_s']:.2f}s/{st['batches']}b"
             for name, st in snap["lanes"].items() if st["batches"]}
    print(f"  requests={snap['requests']} batches={snap['batches']} "
          f"occupancy={snap['mean_occupancy']:.2f} lanes={lanes} "
          f"suspended={snap['suspended_batches']} "
          f"modeled_joules={snap['modeled_joules']:.2f}")
    out["metrics"] = snap
    return out


def run(workdir: str, device: str) -> dict:
    """The four acts over ``workdir`` (left in place for the caller)."""
    out = serve_and_stream(workdir, device)
    out.update(preempt_and_resume(workdir, device))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    workdir = tempfile.mkdtemp(prefix="svc_demo_")
    try:
        return run(workdir, args.device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
