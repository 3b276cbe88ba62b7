#!/usr/bin/env python3
"""The synchronising CUDA operations of one job of each benchmark cell, at
the cell's full size, beside the program's own ``host_syncs`` count.

    python3 scripts/span_syncs.py [--root CHECKOUT] [--seed N] \
        [--cells kmeans-d4.fit dbscan-d4.fit]

``--root`` names the checkout whose port (``src/``) and benchmark
(``portbench/``) are run, by default this one.  Each cell's dataset 0 is
drawn from the seed and its solver run once to build and warm its
kernels; then once more under ``torch.cuda.set_sync_debug_mode("warn")``
with a CPU profiler on.  Every warning raised inside the solver call
(the program's fit span) is counted by the source line that raised it.
Prints one JSON line a cell: the warnings, by line and in all, and the
program's counters (``repro_torch.runtime.spans.counts()``; null where
the checkout has no such module).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import warnings
from pathlib import Path


def solver(config: dict, x, seed: int):
    """The call each job of the cell makes (``portbench/entries/``)."""
    from portbench import inputs
    from repro_torch.core import dbscan, kmeans
    from repro_torch.core.cancellation import CancellationToken

    if config["algorithm"] == "kmeans":
        cfg = kmeans.KMeansConfig(k=config["k"],
                                  max_iters=config["iterations"],
                                  tol=float(config["tol"]))
        c0 = inputs.initial_centroids(x, config["k"], seed, 0)
        return lambda: kmeans.fit_cancellable(
            0, x, cfg, token=CancellationToken(), centroids=c0)
    cfg = dbscan.DBSCANConfig(eps=float(config["eps"]),
                              min_pts=int(config["min_pts"]))
    return lambda: dbscan.fit_cancellable(x, cfg, token=CancellationToken())


def syncs(cell: str, seed: int) -> dict:
    import torch

    from portbench import inputs, spec

    bench = spec.benchmark()
    config = spec.config(bench, spec.cell(bench, cell)["config"])
    x = inputs.datasets(config, seed, 1, torch.device("cuda"))[0]
    run = solver(config, x, seed)
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchronizing CUDA operation" in str(w.message))
    try:
        from repro_torch.runtime import spans
        counts = spans.counts()
    except ImportError:
        counts = None
    out = {"cell": cell, "seed": seed, "warnings": sum(where.values()),
           "by_line": dict(sorted(where.items())), "counts": counts}
    for name in ("iterations", "expansions", "n_clusters"):
        if hasattr(result, name):
            out[name] = int(getattr(result, name))
    if hasattr(result, "core_mask"):
        out["core_points"] = int(result.core_mask.sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--cells", nargs="*",
                    default=["kmeans-d4.fit", "dbscan-d4.fit"])
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    for cell in args.cells:
        print(json.dumps(syncs(cell, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
