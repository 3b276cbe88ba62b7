"""Pipeline parallelism: the GPipe fill-drain schedule over a 1-D mesh.

The counterpart of the reference's ``repro/parallel/pipeline.py``.  The
layer stack is split into ``P`` contiguous stages (:func:`split_stages`);
stage ``s`` runs on ``mesh.devices[s]`` with its slice of the stacked
parameters, and M microbatches stream through the stages over M + P - 1
ticks: at tick t stage s takes microbatch t - s, from the input stream
(stage 0) or from stage s - 1's output of the tick before, moved with
``Tensor.to(devices[s])`` (the reference's ``ppermute``; nothing moves
where the mesh repeats a device).  One controller issues every tick, so
stages on distinct cards overlap as far as their streams let them.

Autograd records through the schedule, so the gradient of a pipelined
loss flows back stage by stage: the backward is pipelined as the
reference's (``jax.grad`` through ``ppermute``).

Differences from the reference, by design (ROADMAP.md section 3):

- an idle tick (a stage before its first or after its last microbatch)
  computes nothing; the reference computes on garbage there and masks the
  result out.  The outputs are the same;
- the outputs are stacked on the last stage's device; the reference
  replicates them over the axis with a ``psum``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import Mesh
from repro_torch.models import lm
from repro_torch.models.layers import apply_norm
from repro_torch.tree import tree_leaves, tree_map


def pipeline_apply(
    mesh: Mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    axis: str = "pipe",
):
    """Build a pipelined apply: ``(stage_params, xs) -> ys``.

    ``stage_params``: a tree (nested dicts, or one tensor) whose leaves
    have a leading stage dim of ``mesh.size`` (:func:`split_stages`);
    stage s gets its slice on ``mesh.devices[s]``.  ``xs``: (M, mb, ...)
    microbatches.  Returns (M, mb, ...), ``stage_fn`` applied by every
    stage in turn to each microbatch, on the last stage's device.
    """
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    n_stages = mesh.size

    def apply(stage_params: Any, xs: torch.Tensor) -> torch.Tensor:
        m = xs.shape[0]
        params = [tree_map(lambda p, s=s: p[s].to(mesh.devices[s]),
                           stage_params) for s in range(n_stages)]
        held: list = [None] * n_stages     # held[s]: stage s's last output
        outs: list = [None] * m
        for t in range(m + n_stages - 1):
            # later stages first: each reads what the stage before it
            # held after the previous tick
            for s in reversed(range(n_stages)):
                mb = t - s
                if not 0 <= mb < m:
                    continue                # idle tick: nothing to compute
                dev = mesh.devices[s]
                x_in = (xs[mb] if s == 0 else held[s - 1]).to(dev)
                held[s] = stage_fn(params[s], x_in)
                if s == n_stages - 1:
                    outs[mb] = held[s]
        return torch.stack(outs)

    return apply


def split_stages(tree: Any, n_stages: int) -> Any:
    """Reshape stacked layer params (L, ...) -> (n_stages, L/n_stages, ...)
    (views)."""

    def f(p: torch.Tensor) -> torch.Tensor:
        layers = p.shape[0]
        if layers % n_stages:
            raise ValueError(f"{layers} layers do not split into {n_stages} "
                             f"stages")
        return p.reshape(n_stages, layers // n_stages, *p.shape[1:])

    return tree_map(f, tree)


def lm_stage_fn(cfg: ModelConfig):
    """A stage of the LM's layer stack for :func:`pipeline_apply`: the
    stage's layer groups in order, each :func:`repro_torch.models.lm.
    hidden_forward`'s group body (remat as ``cfg.remat`` says).  The MoE
    aux loss is not carried."""
    body = lm._remat(lm._group_body, cfg)

    def stage(stage_params: Dict, x: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        groups = tree_leaves(stage_params)[0].shape[0]
        for g in range(groups):
            x, _aux = body(lm._layer(stage_params, g), x, cfg, positions)
        return x

    return stage


def pipelined_hidden_forward(mesh: Mesh, params: Dict, tokens: torch.Tensor,
                             cfg: ModelConfig,
                             prefix_embeds: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """:func:`repro_torch.models.lm.hidden_forward` of each microbatch,
    the layer groups pipelined over ``mesh`` (``axis`` "pipe").

    ``tokens``: (M, mb, S) (and ``prefix_embeds`` (M, mb, P, d)).  The
    embedding runs on the tokens' device and the final norm on the last
    stage's, each microbatch on its own, as ``hidden_forward`` runs them.
    Returns the final normed hidden states (M, mb, P + S, d); the MoE aux
    loss is not carried.
    """
    xs = torch.stack([
        lm._embed(params, tokens[i], cfg,
                  None if prefix_embeds is None else prefix_embeds[i])
        for i in range(tokens.shape[0])])
    stages = split_stages(params["layers"], mesh.size)
    hs = pipeline_apply(mesh, lm_stage_fn(cfg), mesh.axis)(stages, xs)
    norm = tree_map(lambda p: p.to(hs.device), params.get("final_norm", {}))
    return torch.stack([apply_norm(norm, h, cfg) for h in hs])
