"""DBSCAN against the reference: labels, core mask and eps-degrees are
exact float32 decisions, held point for point.

Every sampled job is compared; the degrees are those of the kernel the
jobs' first call makes, on the same dataset (the core
mask turns on them only where a degree lies near min_pts, the degree
itself on every pair near eps).  The control is the reference with
TF32 products in the program's place.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import dbscan as ref_dbscan


def numbers(labels: torch.Tensor, core: torch.Tensor, degree: torch.Tensor,
            ref: tuple) -> Dict[str, float]:
    ref_labels, ref_core, ref_degree = ref
    return {
        "label_mismatch": float((labels.to(torch.int32) != ref_labels).sum()),
        "core_mismatch": float((core.bool() != ref_core).sum()),
        "degree_mismatch": float((degree.long() != ref_degree).sum()),
    }


def small(config: dict) -> dict:
    """The configuration at 8 x 256 blob points: under 4,095 points, so
    even a fault that leaves every core point a cluster of its own stays
    inside the int16 state word; at 256 points a cluster many degrees
    lie near min_pts."""
    return dict(config, points=8 * 256,
                data=dict(config["data"], points_per_cluster=256))


def control(config: dict, data: List[torch.Tensor], seed: int,
            shared=None) -> Dict[str, float]:
    """The numbers of the TF32 reference put in the program's place, on
    dataset 0."""
    x = data[0]
    eps, mp = float(config["eps"]), int(config["min_pts"])
    ref = ref_dbscan.fit(x, eps, mp)
    return numbers(*ref_dbscan.fit(x, eps, mp, "tf32"), ref)


def check(entry, config: dict, data: List[torch.Tensor], seed: int,
          sampled) -> List[Dict[str, float]]:
    per_job = []
    for i in sorted({job.dataset for job in sampled}):
        x = data[i]
        degree = entry.degrees(i).to(x.device)
        ref = ref_dbscan.fit(x, float(config["eps"]), int(config["min_pts"]))
        per_job += [numbers(job.answer["labels"].to(x.device),
                            job.answer["core_mask"].to(x.device), degree,
                            ref)
                    for job in sampled if job.dataset == i]
    return per_job
