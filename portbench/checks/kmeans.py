"""K-Means (Lloyd from the given initial centroids, a fixed number of
steps) against the reference.

fp32 Lloyd trajectories part at near-ties, and a changed order of a sum
moves later labels, so the window's labels are not held to a reference
run's one by one.  Three numbers are compared for each sampled job:

- ``label_mismatch``: the job's last step resumed through the same entry
  from the reference's centroids before its last step; the points whose
  label lies farther from them than the nearest centroid by more than
  float32 rounding (``reference.kmeans.label_mismatch``): the search;
- ``inertia_gap``: |program's inertia - reference's| / reference's, the
  whole run from the same start: the trajectory;
- ``update_gap``: the program's final centroids against the exact means
  of the points its own final labels give each, over the largest |x|:
  the update.

The control is the reference's Lloyd with TF32 products in the
program's place.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import inputs
from portbench.reference import kmeans as ref_kmeans


def numbers(x: torch.Tensor, ref: dict, labels: torch.Tensor,
            centroids: torch.Tensor, inertia: float,
            step_labels: torch.Tensor) -> Dict[str, float]:
    """The numbers of one job: the program's final labels, centroids and
    inertia, and the labels of its last step from ``ref["last"]``,
    against ``ref``, the reference's run from the job's initial
    centroids (``reference.kmeans.lloyd``)."""
    return {
        "label_mismatch": float(ref_kmeans.label_mismatch(
            x, ref["last"], step_labels)),
        "inertia_gap": abs(float(inertia) - ref["inertia"]) / ref["inertia"],
        "update_gap": ref_kmeans.update_gap(x, labels, centroids),
    }


def small(config: dict) -> dict:
    """The configuration at 8 x 512 blob points and 10 steps."""
    return dict(config, points=8 * 512, iterations=10,
                data=dict(config["data"], points_per_cluster=512))


def control(config: dict, data: List[torch.Tensor], seed: int,
            shared=None) -> Dict[str, float]:
    """The numbers of the TF32 reference put in the program's place, on
    dataset 0 from job 0's initial centroids."""
    x = data[0]
    c0 = inputs.initial_centroids(x, config["k"], seed, 0)
    ref = ref_kmeans.lloyd(x, c0, config["iterations"])
    low = ref_kmeans.lloyd(x, c0, config["iterations"], "tf32")
    step = ref_kmeans.nearest(x, ref["last"], "tf32")[0]
    return numbers(x, ref, low["labels"], low["centroids"], low["inertia"],
                   step)


def check(entry, config: dict, data: List[torch.Tensor], seed: int,
          sampled) -> List[Dict[str, float]]:
    per_job = []
    for job in sampled:
        x = data[job.dataset]
        c0 = inputs.initial_centroids(x, config["k"], seed, job.index)
        ref = ref_kmeans.lloyd(x, c0, config["iterations"])
        step = entry.last_step(job.index, ref["last"])
        a = job.answer
        per_job.append(numbers(x, ref, a["labels"].to(x.device),
                               a["centroids"].to(x.device), a["inertia"],
                               step.to(x.device)))
    return per_job
