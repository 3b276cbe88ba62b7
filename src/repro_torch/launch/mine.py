"""The paper's data mining app, as a launcher: DBSCAN/K-Means jobs with
cancellation, persistence and progress readout, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.mine --algo dbscan \
        --features 2 --clusters 6 --size 1024 --workdir "$(mktemp -d)"

The job runs on the CUDA device unless ``--device cpu`` is given; with no
GPU and no ``--device cpu`` it raises instead of running on the host.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.core import dbscan, kmeans
from repro_torch.core.cancellation import CancellationToken
from repro_torch.core.jobs import JobState, JobStore
from repro_torch.data.synthetic import ClusterSpec, make_blobs
from repro_torch.runtime import backend as backend_mod
from repro_torch.runtime.preemption import HoldAlive, PreemptionGuard


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mining_job(
    *,
    algo: str,
    features: int,
    clusters: int,
    size: int,
    workdir: str,
    use_kernel: bool = True,
    seed: int = 0,
    token: CancellationToken | None = None,
    device: str = "cuda",
) -> dict:
    dev = backend_mod.load(device).device
    jobs = JobStore(os.path.join(workdir, "jobs.db"))
    try:
        jobs.recover_orphans()
        jid = jobs.enqueue("mine", {
            "algo": algo, "features": features, "clusters": clusters,
            "size": size, "device": device,
        })
        job = jobs.claim(jid)
        if job is None:
            raise RuntimeError(f"job {jid} was claimed by another launcher")

        spec = ClusterSpec(features, clusters, size)
        x, _, _ = make_blobs(seed, spec, device=dev)
        token = token or CancellationToken()

        _sync(dev)
        t0 = time.time()
        result: dict = {"job_id": job.job_id, "algo": algo, "device": str(dev)}
        with PreemptionGuard(token), HoldAlive(jobs, job.job_id):
            if algo == "dbscan":
                cfg = dbscan.DBSCANConfig.paper_defaults(features)
                cfg = dbscan.DBSCANConfig(
                    eps=cfg.eps, min_pts=cfg.min_pts, use_kernel=use_kernel
                )
                res = dbscan.fit_cancellable(
                    x, cfg, token=token,
                    on_progress=lambda cid, nexp: jobs.report_progress(
                        job.job_id, clusters_found=cid, expansions=nexp
                    ),
                )
                result.update(
                    n_clusters=int(res.n_clusters),
                    expansions=int(res.expansions),
                    noise=int((res.labels == 0).sum()),
                    cancelled=res.cancelled,
                    labels=res.labels,
                )
            elif algo == "kmeans":
                cfg = kmeans.KMeansConfig(k=clusters, use_kernel=use_kernel)
                res = kmeans.fit_cancellable(
                    seed, x, cfg, token=token,
                    on_progress=lambda it, shift: jobs.report_progress(
                        job.job_id, step=it, shift=shift
                    ),
                )
                result.update(
                    iterations=int(res.iterations),
                    inertia=float(res.inertia),
                    converged=bool(res.converged),
                    cancelled=res.cancelled,
                    labels=res.labels,
                )
            else:
                raise ValueError(f"unknown algo {algo!r}")
            _sync(dev)

            final = JobState.SUSPENDED if result.get("cancelled") \
                else JobState.SUCCEEDED
            jobs.transition(job.job_id, final)
    finally:
        jobs.close()
    result["wall_s"] = time.time() - t0
    result["final_state"] = final.value
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=("dbscan", "kmeans"), required=True)
    ap.add_argument("--features", type=int, default=2)
    ap.add_argument("--clusters", type=int, default=6)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--workdir", default=None,
                    help="job store and checkpoints (default: a new "
                         "directory under TMPDIR)")
    ap.add_argument("--no-kernel", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    out = run_mining_job(
        algo=args.algo, features=args.features, clusters=args.clusters,
        size=args.size,
        workdir=args.workdir or tempfile.mkdtemp(prefix="repro_mine_"),
        use_kernel=not args.no_kernel,
        device=args.device,
    )
    out.pop("labels")
    print(out)


if __name__ == "__main__":
    main()
