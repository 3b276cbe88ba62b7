"""Atomic, checksummed checkpoints (the reference's on-disk layout)."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    CheckpointCorrupt,
    CheckpointStore,
    latest_step,
)

__all__ = [
    "AsyncCheckpointer",
    "CheckpointCorrupt",
    "CheckpointStore",
    "latest_step",
]
