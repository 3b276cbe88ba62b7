"""The paper's app end-to-end: persistent mining jobs with progress readout,
cooperative cancellation, and resume — on a grid of datasets.

    PYTHONPATH=src python -m repro_torch.examples.mine_cluster
    PYTHONPATH=src python -m repro_torch.examples.mine_cluster --device cpu

The counterpart of the reference's ``examples/mine_cluster.py``.  The
cancelled job ends SUSPENDED when the 50 ms cancel lands before it
finishes and SUCCEEDED when it does not (a fast card may finish first);
the example prints which.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.core import CancellationToken, cancel_after
from repro_torch.core.jobs import JobStore
from repro_torch.launch.mine import run_mining_job

# a small slice of the paper's 60-tuple grid: (features, clusters, size)
GRID = [(2, 4, 256), (2, 8, 512), (4, 6, 256)]
ALGOS = ("kmeans", "dbscan")
CANCEL_AFTER_S = 0.05
CANCELLED_JOB = dict(algo="dbscan", features=4, clusters=8, size=2048)


def run_grid(workdir: str, device: str, *,
             use_kernel: bool = True) -> list:
    """One job per (grid tuple, algorithm); the jobs' result dicts."""
    outs = []
    for features, clusters, size in GRID:
        for algo in ALGOS:
            out = run_mining_job(
                algo=algo, features=features, clusters=clusters, size=size,
                workdir=workdir, use_kernel=use_kernel, device=device,
            )
            outs.append(out)
            extra = (f"iters={out.get('iterations')}"
                     if algo == "kmeans"
                     else f"clusters={out.get('n_clusters')}")
            print(f"{algo:7s} f={features} c={clusters} s={size}: "
                  f"{out['final_state']} in {out['wall_s']:.2f}s ({extra})")
    return outs


def run_cancelled(workdir: str, device: str) -> dict:
    """The paper's button press, 50 ms in."""
    token = CancellationToken()
    cancel_after(token, CANCEL_AFTER_S)
    out = run_mining_job(workdir=workdir, token=token, device=device,
                         **CANCELLED_JOB)
    print(f"cancelled job -> {out['final_state']} "
          f"(cancelled={out.get('cancelled')}) after {out['wall_s']:.2f}s")
    return out


def read_back(workdir: str) -> list:
    """The activity reattach: read progress back from the store."""
    jobs = JobStore(f"{workdir}/jobs.db")
    try:
        listed = jobs.list_jobs()
    finally:
        jobs.close()
    for job in listed:
        print(f"  job {job.job_id}: {job.kind} {job.state.value} "
              f"progress={job.progress}")
    return listed


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    # a directory made here is removed at the end; a given one is kept
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_mine_")
    print(f"workdir: {workdir}")
    try:
        grid = run_grid(workdir, args.device)
        cancelled = run_cancelled(workdir, args.device)
        jobs = read_back(workdir)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    return {"workdir": workdir, "grid": grid, "cancelled": cancelled,
            "jobs": jobs}


if __name__ == "__main__":
    main()
