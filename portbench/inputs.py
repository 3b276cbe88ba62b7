"""The benchmark's inputs, drawn from ``--seed``.

A configuration names the generator of its inputs (``data.generator``),
``portbench/generators/<name>.py`` (:func:`portbench.spec.generator`).
Datasets and the inputs a run shares are drawn by a ``torch.Generator``
on the device in a few large calls, so set-up stays short and the same
seed gives the same inputs; a job's initial rows are drawn on the host.
Each stream of numbers (a dataset, the inputs a run shares, a job's
initial rows) has its own generator, seeded from (seed, stream, index).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench import spec

DATA, INIT, SAMPLE, SHARED = 1, 2, 3, 4


def stream_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit seed for one stream, from any whole number ``seed``."""
    words = np.random.SeedSequence(
        [seed % (1 << 64), stream, index]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, stream: int, index: int,
              device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


def datasets(config: dict, seed: int, count: int,
             device: torch.device) -> list:
    """The ``count`` datasets of a run, dataset i from (seed, i)."""
    gen = spec.generator(config["data"]["generator"])
    return [gen.dataset(config, generator(seed, DATA, i, device))
            for i in range(count)]


def shared(config: dict, seed: int, device: torch.device):
    """The inputs every job of a run shares, such as a model's weights,
    from (seed); None where the configuration's generator draws none."""
    gen = spec.generator(config["data"]["generator"])
    if not hasattr(gen, "shared"):
        return None
    return gen.shared(config, generator(seed, SHARED, 0, device))


def initial_indices(n: int, k: int, seed: int, job: int) -> List[int]:
    """k distinct row indices below n, drawn from (seed, job) on the host
    in O(k) memory (Floyd's algorithm), the same on every device."""
    if not 0 <= k <= n:
        raise ValueError(f"cannot draw {k} distinct rows of {n}")
    rng = np.random.default_rng(stream_seed(seed, INIT, job))
    picked: List[int] = []
    seen = set()
    for top in range(n - k, n):
        t = int(rng.integers(0, top + 1))
        pick = top if t in seen else t
        seen.add(pick)
        picked.append(pick)
    return picked


def initial_centroids(x: torch.Tensor, k: int, seed: int,
                      job: int) -> torch.Tensor:
    """Job ``job``'s initial centroids: k distinct points of its dataset,
    drawn from (seed, job)."""
    idx = torch.tensor(initial_indices(x.shape[0], k, seed, job),
                       dtype=torch.long).to(x.device)
    return x.index_select(0, idx)
