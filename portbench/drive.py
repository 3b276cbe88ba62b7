"""Drives a cell's traffic through the port.

A traffic file (``portbench/traffic/<mix>.json``) names the entry its
jobs go through (``entry``) and how many datasets a run draws
(``datasets``; job j clusters dataset j mod that), with whatever else
that entry reads.  The entry's driver is ``portbench/entries/<entry>.py``:
its ``Entry`` runs one job, and its ``loop``, where it has one, replaces
:func:`closed_loop`, one client handing over whole jobs back to back.
Only the jobs that a :class:`Reservoir` draws from the seed for the check
keep their answers; every other answer is copied into a host buffer that
the next job reuses.

Only the system under test is imported from ``repro_torch``: its entry
points, its result types and its counters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import inputs, spec


@dataclasses.dataclass
class Job:
    """A finished job: its answer on the host (sampled jobs only), and in
    traced runs the program's counters after it."""

    index: int
    dataset: int
    answer: Optional[dict]
    counters: dict


class Reservoir:
    """A uniform sample of ``count`` of the jobs, drawn from the seed as
    they finish (Vitter's algorithm R), so a run holds only the sampled
    jobs' answers however many jobs its window has."""

    def __init__(self, seed: int, count: int) -> None:
        self.rng = np.random.default_rng(
            inputs.stream_seed(seed, inputs.SAMPLE, 0))
        self.count = count
        self.slots: List[Job] = []

    def admit(self, j: int) -> Optional[int]:
        """The slot job j takes, or None where it is not sampled."""
        if j < self.count:
            return j
        r = int(self.rng.integers(0, j + 1))
        return r if r < self.count else None

    def put(self, slot: int, job: Job) -> None:
        if slot == len(self.slots):
            self.slots.append(job)
        else:
            self.slots[slot] = job

    def jobs(self) -> List[Job]:
        return sorted(self.slots, key=lambda job: job.index)


class Entry:
    """One entry point of the port, driven a job at a time."""

    def __init__(self, config: dict, traffic: dict, data: List[torch.Tensor],
                 seed: int, shared=None) -> None:
        self.config = config
        self.traffic = traffic
        self.data = data
        self.seed = seed
        # what every job shares (:func:`portbench.inputs.shared`), such as
        # a model's weights: part of each job's footprint
        self.shared = shared
        self._scratch: Dict[str, torch.Tensor] = {}

    def dataset(self, j: int) -> int:
        return j % len(self.data)

    def run(self, j: int) -> object:
        raise NotImplementedError

    def fetch(self, result, keep: bool) -> dict:
        """The job's answer, copied to the host (:meth:`host`): a job ends
        when the user holds its answer."""
        raise NotImplementedError

    def host(self, name: str, t: torch.Tensor, keep: bool) -> torch.Tensor:
        """``t`` copied to host memory: a tensor of its own where the
        answer is kept, else the buffer ``name`` that every job reuses."""
        if keep:
            return t.cpu()
        buf = self._scratch.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._scratch[name] = torch.empty(t.shape, dtype=t.dtype)
        return buf.copy_(t)

    def counters(self, result) -> dict:
        """The program's counters after a job (read in traced runs)."""
        return {}

    def resident_bytes(self) -> int:
        """Device bytes of the inputs the benchmark holds for all its jobs."""
        return sum(x.nbytes for x in self.data)

    def job_bytes(self) -> int:
        """Device bytes of one job's inputs."""
        return max(x.nbytes for x in self.data)


def entry(config: dict, traffic: dict, data: List[torch.Tensor],
          seed: int, shared=None) -> Entry:
    """The entry the traffic names, driven over ``data``."""
    return spec.driver(traffic["entry"]).Entry(config, traffic, data, seed,
                                               shared)


def loop(e: Entry) -> Callable:
    """The entry's own loop, or :func:`closed_loop`."""
    return getattr(spec.driver(e.traffic["entry"]), "loop", closed_loop)


def closed_loop(e: Entry, seconds: float, sync: Callable[[], None],
                traced: bool, span: Callable[[str], object],
                sample: Reservoir) -> Tuple[List[Job], float]:
    """Jobs 0, 1, ... one after another until ``seconds`` have passed; the
    job in flight then is finished and counted.  Returns the jobs (their
    counters; the answers go to ``sample``) and the window's length in
    seconds, to the end of the last job."""
    jobs: List[Job] = []
    sync()
    t0 = time.perf_counter()
    j = 0
    while True:
        slot = sample.admit(j)
        with span("portbench.job"):
            result = e.run(j)
            answer = e.fetch(result, slot is not None)
            sync()
        counters = e.counters(result) if traced else {}
        jobs.append(Job(j, e.dataset(j), None, counters))
        if slot is not None:
            sample.put(slot, Job(j, e.dataset(j), answer, counters))
        del result, answer
        j += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return jobs, time.perf_counter() - t0
