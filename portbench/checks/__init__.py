"""Whether what the timed path produced is correct.

After the window closes, a sample of the finished jobs drawn from the
seed (``sample`` in ``portbench/cells/<cell>.json``; the run's
:class:`portbench.drive.Reservoir`) is worked out again
by the plain reference (:mod:`portbench.reference`) from the benchmark's
own inputs, and each number compared is held to its limit there.  How an
algorithm's answers are compared is ``portbench/checks/<algorithm>.py``
(the configuration's ``algorithm``): its ``check`` returns the numbers of
each sampled job.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import spec
from portbench.drive import Entry, Job

Numbers = Dict[str, float]


def check(entry: Entry, config: dict, data: List[torch.Tensor], seed: int,
          sampled: List[Job], limits: dict) -> tuple:
    """(numbers, failed jobs): the worst of each compared number over the
    sampled jobs, and how many of them broke a limit."""
    bound = {k: v["limit"] for k, v in limits["numbers"].items()}
    per_job: List[Numbers] = spec.comparison(config["algorithm"]).check(
        entry, config, data, seed, sampled)
    failed = sum(1 for n in per_job if any(n[k] > bound[k] for k in bound))
    return {k: max(n[k] for n in per_job) for k in bound}, failed
