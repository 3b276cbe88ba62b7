"""Elastic restart: restore a checkpoint onto a different mesh.

A job checkpointed on a mesh of four shards must be resumable on one (and
back again).  Checkpoints store *global* logical arrays (see store.py), so
resharding is a placement decision at restore time, not a data
transformation:

    state = restore_resharded(store, step, like=state_like, mesh=new_mesh,
                              placement_fn=placement)

``placement_fn(like, mesh)`` gives the device of every leaf, evaluated
against the *new* mesh — the one rule that keeps the save mesh and the
restore mesh independent.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.checkpoint.store import (
    CheckpointStore,
    _tree_map_with_path,
    as_tensor,
    tree_flatten_with_path,
)

__all__ = ["emergency_save", "restore_resharded"]


def restore_resharded(
    store: CheckpointStore,
    step: int,
    like: Any,
    mesh: Any,
    placement_fn: Callable[[Any, Any], Any],
) -> Any:
    """Restore ``step`` into the structure of ``like``, each leaf a tensor
    on the device ``placement_fn(like, mesh)`` gives it (a tree of that
    structure whose leaves are ``torch.device``)."""
    devices = dict(tree_flatten_with_path(placement_fn(like, mesh)))
    return _tree_map_with_path(
        lambda path, arr: as_tensor(arr, devices[path]),
        store.restore(step, like))


def emergency_save(
    store: CheckpointStore, step: int, tree: Any, reason: str
) -> Optional[str]:
    """Best-effort synchronous save on the preemption path.

    Never raises (the process is already going down); returns the directory
    on success, None on failure.
    """
    try:
        return store.save(step, tree, metadata={"emergency": True,
                                                "reason": reason})
    except BaseException:
        return None
