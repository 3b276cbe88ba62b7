"""Dry-run for the paper's own technique at pod scale: one distributed
K-Means step over pod-sharded points, on the meta device.

The counterpart of the reference's ``repro/launch/dryrun_cluster.py``, at
its shape (the "pod-scale data mining" cell):

    kmeans_16m:  n = 16,777,216 points, d = 128 features, k = 4096 centroids

    PYTHONPATH=src python -m repro_torch.launch.dryrun_cluster \\
        [--multi-pod | --both-meshes] [--dtype float32|bfloat16]

The points shard over the mesh's (pod, data) axes and every shard holds
all the centroids.  One device's step is traced on meta tensors
(``launch/cells.trace_step``): :func:`repro_torch.core.distributed.
clustering_step_for_dryrun` with the kernel route, whose two passes take
their shape ops on the meta device (FLOPs 2 n k d + n d for pass 1).  The
record has the reference's fields; its ``collectives`` are modelled: the
(k d + k + 1) partial floats all-reduced over the data axes, the step's one
collective of any size.  ``chip_smoke.py`` phase 6 runs the same step for
real on one H100.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.distributed import clustering_step_for_dryrun
from repro_torch.core.kmeans import KMeansConfig
from repro_torch.launch import cells
from repro_torch.launch.dryrun import RESULTS_DIR, mesh_label, save_result
from repro_torch.launch.hlo import inventory
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import _axes_size, _filter_axes

KMEANS_N = 16 * 1024 * 1024
KMEANS_D = 128
KMEANS_K = 4096


def kmeans_cell(mesh, dtype: torch.dtype = torch.float32,
                tag: str = "") -> dict:
    """The record of one K-Means step of the pod-scale cell on ``mesh`` (an
    abstract mesh), per device."""
    dp = _axes_size(mesh, _filter_axes(mesh, ("pod", "data")))
    n = KMEANS_N // dp
    step = clustering_step_for_dryrun(KMeansConfig(k=KMEANS_K))
    x = torch.empty((n, KMEANS_D), dtype=dtype, device="meta")
    c = torch.empty((KMEANS_K, KMEANS_D), dtype=torch.float32, device="meta")
    # the kernels take float32 points: a bfloat16 x is widened in the step,
    # as the reference's step widens it
    trace = cells.trace_step(lambda x, c: step(x.float(), c), (x, c))
    stride = KMEANS_K * KMEANS_D + KMEANS_K + 1
    coll = inventory([("all-reduce", stride * 4, dp, 1)])
    args = n * KMEANS_D * x.itemsize + KMEANS_K * KMEANS_D * 4
    return {
        "arch": "paper-kmeans",
        "shape": "cluster_16m",
        "mesh": mesh_label(mesh),
        "devices": mesh.size,
        "tag": tag,
        "status": "ok",
        "seconds_trace": trace["seconds"],
        "memory_analysis": {
            "argument_size_in_bytes": args,
            # assignment int32, new centroids, shift, inertia
            "output_size_in_bytes": n * 4 + KMEANS_K * KMEANS_D * 4 + 8,
            "temp_size_in_bytes": trace["temp_size_in_bytes"],
            "temp_is_upper_bound": False,
        },
        "cost_analysis": {"flops": trace["flops"]},
        "collectives": coll,
        # one step, no layer stack: the trace is the total
        "derived": {
            "flops": trace["flops"],
            "temp_size_in_bytes": trace["temp_size_in_bytes"],
            "wire_bytes": coll["total_wire_bytes"],
            "per_op_wire_bytes": {k: v["wire_bytes"]
                                  for k, v in coll["per_op"].items()},
        },
        "n_params": KMEANS_K * KMEANS_D,
        "n_active_params": KMEANS_K * KMEANS_D,
        "n_groups": 1,
        "local_batch": n,
        "problem": {"n": KMEANS_N, "d": KMEANS_D, "k": KMEANS_K,
                    "dtype": str(dtype), "strategy": "sharded fused step"},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    dtype = getattr(torch, args.dtype)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        res = kmeans_cell(make_production_mesh(multi_pod=mp), dtype,
                          tag=args.tag)
        path = save_result(res, args.out)
        print(f"OK paper-kmeans cluster_16m [{res['mesh']}] "
              f"trace={res['seconds_trace']:.2f}s "
              f"flops={res['derived']['flops']:.3e} "
              f"args={res['memory_analysis']['argument_size_in_bytes']}B "
              f"wire={res['derived']['wire_bytes']:.3e} -> {path}")


if __name__ == "__main__":
    main()
