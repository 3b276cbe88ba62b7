"""The benchmark's inputs, drawn from ``--seed`` on the device.

A copy of the paper's generator (§II.C: normally distributed points around
randomly placed centres, a random variance for each feature of each
cluster, shuffled), as ``repro_torch/data/synthetic.py:make_blobs`` draws
it.  Everything is drawn by a ``torch.Generator`` on
the device in a few large calls, so set-up stays short and the same seed
gives the same points.  Each stream of numbers (a dataset, a job's initial
centroids) has its own generator, seeded from (seed, stream, index).
"""

from __future__ import annotations

import numpy as np
import torch

DATA, INIT, SAMPLE = 1, 2, 3


def stream_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit seed for one stream, from any whole number ``seed``."""
    words = np.random.SeedSequence(
        [seed % (1 << 64), stream, index]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, stream: int, index: int,
              device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


def make_points(gen: torch.Generator, data: dict,
                features: int) -> torch.Tensor:
    """(n, features) float32 points on the generator's device.

    ``data``: ``clusters`` x ``points_per_cluster`` gaussian points, centres
    uniform in [-center_range, center_range], per-feature sigmas uniform in
    [min_sigma, max_sigma], shuffled.
    """
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


def datasets(config: dict, seed: int, count: int,
             device: torch.device) -> list:
    """The ``count`` datasets of a run, dataset i from (seed, i)."""
    return [make_points(generator(seed, DATA, i, device), config["data"],
                        config["features"]) for i in range(count)]


def initial_centroids(x: torch.Tensor, k: int, seed: int,
                      job: int) -> torch.Tensor:
    """Job ``job``'s initial centroids: k distinct points of its dataset,
    drawn from (seed, job)."""
    gen = generator(seed, INIT, job, x.device)
    idx = torch.randperm(x.shape[0], generator=gen, device=x.device)[:k]
    return x[idx].contiguous()
