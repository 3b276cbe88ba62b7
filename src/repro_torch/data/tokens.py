"""Token pipeline for the LM substrate.

Synthetic-corpus batches are pure functions of (seed, step), which makes the
pipeline *restartable by construction*: a resumed job replays the exact batch
stream from the step counter in its checkpoint — the WorkManager property
(jobs survive restarts) applied to data.

The counterpart of the reference's ``repro/data/tokens.py``.  Each batch is
drawn from a ``torch.Generator`` seeded from (seed, step)
(:func:`step_generator`, the reference's ``fold_in(key, step)``), so the
numbers differ from the reference's ``jax.random`` stream; the distribution
and the replay contract are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TokenBatch:
    """One training batch.

    tokens/labels: (batch, seq) int64; labels are tokens shifted left.
    embeddings: optional (batch, frames, d_model) float for stub frontends.
    """

    tokens: torch.Tensor
    labels: torch.Tensor
    embeddings: Optional[torch.Tensor] = None


def fold_in(seed: int, step: int) -> int:
    """A 63-bit seed for ``step`` of the stream ``seed``, mixed so that
    neighbouring (seed, step) pairs give unrelated streams."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def step_generator(seed: int, step: int,
                   device: torch.device | str = "cpu") -> torch.Generator:
    """The generator on ``device`` that draws batch ``step`` of ``seed``."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, step))


def synthetic_token_batch(
    generator: torch.Generator,
    *,
    batch: int,
    seq: int,
    vocab: int,
    skew: float = 4.0,
) -> TokenBatch:
    """Power-law token ids: p(id) ∝ id^(1/skew - 1), O(B*S) sampling.

    (Uniform ids make loss curves degenerate; a true Zipf categorical costs
    O(B*S*V) — this inverse-CDF power law gives the heavy head at gather
    cost.)  Drawn on the generator's device.
    """
    u = torch.rand((batch, seq), generator=generator,
                   device=generator.device)
    u = u * (1.0 - 1e-9) + 1e-9   # the reference's uniform on [1e-9, 1)
    ids = (vocab * u ** skew).to(torch.int64).clamp_(0, vocab - 1)
    labels = torch.roll(ids, -1, dims=1)
    return TokenBatch(tokens=ids, labels=labels)


def synthetic_token_batches(
    seed: int,
    *,
    batch: int,
    seq: int,
    vocab: int,
    start_step: int = 0,
    device: torch.device | str = "cpu",
) -> Iterator[TokenBatch]:
    """Infinite, replayable batch stream keyed by step index."""
    step = start_step
    while True:
        yield synthetic_token_batch(step_generator(seed, step, device),
                                    batch=batch, seq=seq, vocab=vocab)
        step += 1


__all__ = ["TokenBatch", "fold_in", "step_generator",
           "synthetic_token_batch", "synthetic_token_batches"]
