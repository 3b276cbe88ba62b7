"""LR schedules, including MiniCPM's WSD (warmup-stable-decay).

WSD (arXiv:2404.06395 §4): linear warmup to peak, long stable phase at peak,
short exponential/linear decay tail — designed so checkpoints in the stable
phase can branch to a decay at any time (pairs naturally with this repo's
suspend/resume machinery: a preempted job resumed with fewer remaining steps
re-derives its decay point from the schedule, not from wall clock).

The counterpart of the reference's ``repro/optim/schedule.py``.  Each
schedule maps a step (an int or a tensor, e.g. ``TrainState.step`` on the
card) to a float32 scale on the step's device, without a host sync.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def wsd_schedule(
    total_steps: int,
    *,
    warmup_frac: float = 0.01,
    decay_frac: float = 0.1,
    final_scale: float = 0.1,
) -> Callable:
    warmup = max(1, int(total_steps * warmup_frac))
    decay = max(1, int(total_steps * decay_frac))
    stable_end = total_steps - decay

    def fn(step):
        step = _step(step)
        w = torch.clamp(step / warmup, max=1.0)
        d = torch.where(
            step <= stable_end,
            1.0,
            1.0 - (1.0 - final_scale) * (step - stable_end) / decay,
        )
        return w * torch.clamp(d, final_scale, 1.0)

    return fn


def cosine_schedule(total_steps: int, *, warmup_frac: float = 0.01,
                    final_scale: float = 0.1) -> Callable:
    warmup = max(1, int(total_steps * warmup_frac))

    def fn(step):
        step = _step(step)
        w = torch.clamp(step / warmup, max=1.0)
        t = torch.clamp((step - warmup) / max(1, total_steps - warmup),
                        0.0, 1.0)
        c = final_scale + (1 - final_scale) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return w * c

    return fn


def constant_schedule(total_steps: int, **_) -> Callable:
    del total_steps
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


SCHEDULES = {
    "wsd": wsd_schedule,
    "cosine": cosine_schedule,
    "constant": constant_schedule,
}


def make_schedule(name: str, total_steps: int, **kw) -> Callable:
    return SCHEDULES[name](total_steps, **kw)
