"""Quickstart: the paper's two algorithms through the public API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The counterpart of the reference's ``examples/quickstart.py``.  On the card
K-Means runs the assignment kernel (``csrc/distance.cu``) and DBSCAN the
degree and expansion kernels (``csrc/neighbor.cu``); on the CPU each takes
its plain version.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core import dbscan, kmeans
from repro_torch.data.synthetic import ClusterSpec, make_blobs
from repro_torch.runtime import backend

# the paper's dataset: 6 gaussian clusters, 2 features (Fig 2/3)
SPEC = ClusterSpec(features=2, clusters=6, points_per_cluster=1024)


def make_dataset(device, seed: int = 0) -> torch.Tensor:
    x, _, _ = make_blobs(seed, SPEC, device=device)
    return x


def run_kmeans(x: torch.Tensor, k: int, *, seed: int = 1,
               use_kernel: bool = True) -> kmeans.KMeansResult:
    """K-Means with the paper's stop rule (tol 1e-6, max 100k iters)."""
    cfg = kmeans.KMeansConfig(k=k, use_kernel=use_kernel)
    return kmeans.fit(seed, x, cfg)


def run_dbscan(x: torch.Tensor, features: int, *,
               use_kernel: bool = True) -> dbscan.DBSCANResult:
    """DBSCAN with the paper's defaults (minPts=10*f, eps=sqrt(f))."""
    cfg = dataclasses.replace(dbscan.DBSCANConfig.paper_defaults(features),
                              use_kernel=use_kernel)
    return dbscan.fit(x, cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    # 1. explicit backend load (the wrapper-library discipline)
    be = backend.discover_backend(args.device)
    print(f"backend: {be.platform} x{be.device_count} "
          f"(chip: {be.chip.name})")

    # 2. the dataset
    x = make_dataset(be.device)
    print(f"dataset: {x.shape[0]} points, {SPEC.features} features")

    # 3. K-Means
    kres = run_kmeans(x, SPEC.clusters)
    print(f"kmeans:  {int(kres.iterations)} iterations, "
          f"inertia {float(kres.inertia):.1f}, "
          f"converged={bool(kres.converged)}")

    # 4. DBSCAN
    dres = run_dbscan(x, SPEC.features)
    labels = dres.labels.cpu()
    print(f"dbscan:  {int(dres.n_clusters)} clusters, "
          f"{int((labels == 0).sum())} noise points, "
          f"{int(dres.expansions)} expansion-kernel launches")
    return {"x": x, "kmeans": kres, "dbscan": dres}


if __name__ == "__main__":
    main()
