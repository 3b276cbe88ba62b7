"""The paper's gaussian blobs (arXiv:2112.04800, section II.C).

Normally distributed points around randomly placed centres, a random
variance for each feature of each cluster, shuffled, as
``repro_torch/data/synthetic.py:make_blobs`` draws them.  The
configuration's ``data`` gives ``clusters`` x ``points_per_cluster``
points of ``features`` float32 features, centres uniform in
[-center_range, center_range], per-feature sigmas uniform in
[min_sigma, max_sigma].
"""

from __future__ import annotations

import torch


def make_points(gen: torch.Generator, data: dict,
                features: int) -> torch.Tensor:
    """(n, features) float32 points on the generator's device."""
    dev = gen.device
    c, m, f = data["clusters"], data["points_per_cluster"], features
    r = float(data["center_range"])
    lo, hi = float(data["min_sigma"]), float(data["max_sigma"])
    centers = torch.rand((c, f), generator=gen, device=dev) * (2 * r) - r
    sigmas = torch.rand((c, f), generator=gen, device=dev) * (hi - lo) + lo
    labels = torch.arange(c, device=dev).repeat_interleave(m)
    points = torch.randn((c * m, f), generator=gen, device=dev)
    points = points.mul_(sigmas[labels]).add_(centers[labels])
    del labels
    perm = torch.randperm(points.shape[0], generator=gen, device=dev)
    return points[perm].contiguous()


def dataset(config: dict, gen: torch.Generator) -> torch.Tensor:
    return make_points(gen, config["data"], config["features"])


def check(config: dict) -> None:
    """The points the work counts use are the points the data draws."""
    data = config["data"]
    drawn = data["clusters"] * data["points_per_cluster"]
    if config["points"] != drawn:
        raise ValueError(f"{config['name']}: points {config['points']} but "
                         f"the blobs draw {drawn}")
