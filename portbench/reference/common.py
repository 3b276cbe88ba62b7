"""Helpers shared by the reference's algorithms."""

from __future__ import annotations

import torch

# Elements of one block's temporary (64 Mi: 512 MiB of float64).
BLOCK_ELEMS = 1 << 26


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away),
    as the tensor cores take float32 inputs."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def rows_per_block(cols: int, elems: int = BLOCK_ELEMS) -> int:
    return max(1, elems // max(1, cols))
