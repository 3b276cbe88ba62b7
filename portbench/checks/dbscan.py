"""DBSCAN against the reference: labels, core mask and eps-degrees are
exact float32 decisions, held point for point.

Every sampled job is compared; the degrees are those of the kernel the
jobs' first call makes, on the same dataset (the core
mask turns on them only where a degree lies near min_pts, the degree
itself on every pair near eps).
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
