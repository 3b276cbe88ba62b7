"""The paper's synthetic dataset generator.

Paper §II.C: "We generate normally distributed random data with randomly
selected cluster centers and randomly selected variances.  Different
variances are allowed for each feature [...].  All data items are shuffled
randomly before the execution of the data mining algorithms."

Grid used by the paper: features ∈ {1,2,4}, clusters ∈ {2,4,6,8},
points-per-cluster ∈ {128,256,512,1024,2048} → 60 tuples.

Generation is driven by a ``torch.Generator`` (or an integer seed), so a
dataset is reproducible within this package — a resumed job regenerates the
same points from its seed.  It cannot reproduce the reference package's
``jax.random`` bits; tests that compare the two packages make their inputs
with numpy and hand them to both.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np
import torch

# The paper's 60-tuple grid.
PAPER_FEATURES = (1, 2, 4)
PAPER_CLUSTERS = (2, 4, 6, 8)
PAPER_CLUSTER_SIZES = (128, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One tuple of the paper's benchmark grid."""

    features: int
    clusters: int
    points_per_cluster: int

    @property
    def n_points(self) -> int:
        return self.clusters * self.points_per_cluster

    # The paper's fixed hyper-parameter rules (§II.C):
    @property
    def dbscan_min_pts(self) -> int:
        return 10 * self.features

    @property
    def dbscan_eps(self) -> float:
        return float(np.sqrt(self.features))


def paper_grid() -> Tuple[ClusterSpec, ...]:
    return tuple(
        ClusterSpec(f, c, s)
        for f in PAPER_FEATURES
        for c in PAPER_CLUSTERS
        for s in PAPER_CLUSTER_SIZES
    )


def make_blobs(
    seed: Union[int, torch.Generator],
    spec: ClusterSpec,
    *,
    center_range: float = 10.0,
    min_sigma: float = 0.15,
    max_sigma: float = 0.8,
    sizes: Sequence[int] | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate shuffled gaussian clusters.

    Returns ``(points, true_labels, centers)`` with
    ``points.shape == (n, features)``.  ``sizes`` overrides equal cluster
    sizes (paper: "allows to generate clusters with unequal cluster sizes").
    Single precision by default, as in the paper.  The numbers are drawn on
    the CPU from ``seed`` (so they do not depend on the device) and then
    moved to ``device``.
    """
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator().manual_seed(int(seed))
    c, f = spec.clusters, spec.features
    if sizes is None:
        sizes = [spec.points_per_cluster] * c
    if len(sizes) != c:
        raise ValueError(f"sizes has {len(sizes)} entries for {c} clusters")
    n = int(sum(sizes))

    centers = (torch.rand((c, f), generator=gen, dtype=dtype)
               * (2 * center_range) - center_range)
    # per-cluster, per-feature variances (paper: different variances per feature)
    sigmas = (torch.rand((c, f), generator=gen, dtype=dtype)
              * (max_sigma - min_sigma) + min_sigma)
    labels = torch.repeat_interleave(
        torch.arange(c, dtype=torch.int32), torch.as_tensor(list(sizes)))
    noise = torch.randn((n, f), generator=gen, dtype=dtype)
    points = centers[labels] + noise * sigmas[labels]

    perm = torch.randperm(n, generator=gen)
    return (points[perm].to(device), labels[perm].to(device),
            centers.to(device))
