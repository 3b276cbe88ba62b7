"""AdamW with fp32 master weights for bf16 models.

The counterpart of the reference's ``repro/optim/adamw.py``.  State layout
(nested dicts mirroring params):
- master: fp32 master copy (omitted when params are already fp32)
- mu, nu: fp32 first/second moments
- count: scalar step (int32 tensor)

Unlike the reference, which returns new trees, :func:`adamw_update` updates
params, moments and master **in place** under ``torch.no_grad()`` and
returns the same tensors: a functional update would hold two copies of the
optimizer state at once (~38 GB for OLMo-1B).  The arithmetic is the
reference's, step for step: a global-norm clip, bias correction by
``count``, decoupled weight decay applied to the master weights, the result
cast back to the model dtype.  Params stay the autograd leaves they were.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaves = tree_leaves(params)
    state = {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32,
                             device=leaves[0].device if leaves else "cpu"),
    }
    if any(p.dtype != torch.float32 for p in leaves):
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted key order) of sum(x^2), fp32."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    state: Dict[str, Any],
    lr_scale: torch.Tensor | float = 1.0,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (params, state, metrics); params and state updated in place."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1c = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    masters = state.get("master", params)

    def upd(p_master, g, mu, nu):
        g = g.to(torch.float32) * clip
        mu.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        p_master.sub_(lr * (step + cfg.weight_decay * p_master))

    tree_map(upd, masters, grads, state["mu"], state["nu"])
    if "master" in state:  # cast back to the model dtype
        tree_map(lambda p, m: p.copy_(m), params, state["master"])
    state["count"] = count
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
