"""Atomic, checksummed checkpoints (the reference's on-disk layout), and
restores onto another mesh (``elastic``)."""

from repro_torch.checkpoint.elastic import emergency_save, restore_resharded
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
    "emergency_save",
    "latest_step",
    "restore_resharded",
]
