"""Carry data and run state between the reference package and this port.

The system has no weights: its state is the points, the K-Means centroids
with their iteration counter, and the DBSCAN run snapshot.  Every function
here takes or returns plain numpy in the reference package's layout (what
its results hold and what ``DBSCANRunState.as_tree()`` gives), so a run
suspended in one package resumes in the other without either importing the
other.  The port's own ``DBSCANRunState.as_tree()`` already is that layout:
the reference's ``DBSCANRunState.from_tree`` takes it as it is.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.dbscan import DBSCANRunState, MAX_CLUSTER_ID
from repro_torch.core.kmeans import KMeansResult

_KMEANS_FIELDS = ("centroids", "labels", "inertia", "iterations", "converged")


def points_from_numpy(x, device: torch.device | str = "cpu") -> torch.Tensor:
    """(n, d) points or (k, d) centroids as a float32 tensor on ``device``."""
    a = np.asarray(x, np.float32)
    if a.ndim != 2:
        raise ValueError(f"need a 2-D array, got shape {a.shape}")
    return torch.tensor(a, device=device)  # a copy: never aliases the caller's array


def kmeans_result_from_numpy(fields: Mapping[str, object],
                             cancelled: bool = False,
                             device: torch.device | str = "cpu"
                             ) -> KMeansResult:
    """A reference ``KMeansResult``'s fields (as numpy) -> the port's.

    Resume with ``fit_cancellable(..., centroids=r.centroids,
    start_iteration=int(r.iterations))``.
    """
    missing = [f for f in _KMEANS_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing K-Means result fields {missing}")
    return KMeansResult(
        centroids=points_from_numpy(fields["centroids"], device),
        labels=torch.tensor(np.asarray(fields["labels"], np.int16),
                            device=device),
        inertia=torch.tensor(float(np.asarray(fields["inertia"])),
                             dtype=torch.float32, device=device),
        iterations=torch.tensor(int(np.asarray(fields["iterations"])),
                                dtype=torch.int32),
        converged=torch.tensor(bool(np.asarray(fields["converged"]))),
        cancelled=bool(cancelled),
    )


def kmeans_result_to_numpy(res: KMeansResult) -> dict:
    """The port's ``KMeansResult`` -> numpy fields in the reference's dtypes."""
    return {
        "centroids": res.centroids.detach().cpu().numpy().astype(np.float32),
        "labels": res.labels.cpu().numpy().astype(np.int16),
        "inertia": np.float32(float(res.inertia)),
        "iterations": np.int32(int(res.iterations)),
        "converged": np.bool_(bool(res.converged)),
    }


def dbscan_state_from_tree(tree: Mapping[str, object]) -> DBSCANRunState:
    """A reference ``DBSCANRunState.as_tree()`` dict -> the port's state."""
    packed = np.asarray(tree["packed"])
    frontier = np.asarray(tree["frontier"])
    if packed.dtype != np.int16:
        raise TypeError(f"packed state word must be int16, got {packed.dtype}")
    if packed.ndim != 1 or frontier.shape != packed.shape:
        raise ValueError(f"packed {packed.shape} and frontier "
                         f"{frontier.shape} must be the same (n,) shape")
    cid = int(tree["cid"])
    if not 0 <= cid <= MAX_CLUSTER_ID:
        raise ValueError(f"cluster id {cid} outside 0..{MAX_CLUSTER_ID}")
    return DBSCANRunState.from_tree(
        {"packed": packed, "frontier": frontier.astype(bool), "cid": cid,
         "nexp": int(tree["nexp"])})
