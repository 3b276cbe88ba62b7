"""Resolve parameter/cache layouts for a concrete (config, mesh) pair.

The counterpart of the reference's ``repro/parallel/resolve.py``.  Built
on the declaration trees (:mod:`repro_torch.models.declare`): every leaf
carries logical axes; this module turns them into :class:`Spec` trees
with two refinements over the raw table lookup:

1. **Shape-aware degradation** (:func:`spec_for_shape`): published dims
   that don't divide the mesh axis (36 heads, kv=2, 24 heads on 16-way TP)
   are replicated instead of failing.

2. **Fan-in fallback**: if an attention projection lost its "heads"
   sharding to rule 1, the freed "model" axis is re-assigned to the
   tensor's "embed" (fan-in/fan-out) dim when that divides, which keeps the
   parameter and its optimizer state sharded over the model axis.

Trees are the port's: nested dicts, and :class:`repro_torch.train.step.
TrainState` (a ``NamedTuple``); an axes leaf is a tuple of logical names
(or ``None``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from repro_torch.parallel.sharding import (
    ShardingRules,
    Spec,
    _axes_size,
    _filter_axes,
    spec_for_shape,
)

_FALLBACK_TRIGGERS = ("heads", "kv_heads", "vocab", "ff", "expert",
                      "ssm_inner")
_FALLBACK_TARGET = "embed"


def spec_for_decl(
    rules: ShardingRules,
    axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    mesh,
) -> Spec:
    spec = spec_for_shape(rules, axes, mesh, shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))

    # did a trigger dim lose its model sharding?
    model_axes = _filter_axes(mesh, "model")
    if model_axes is None:
        return spec
    lost = False
    model_used = False
    for ax, ent in zip(axes, entries):
        wanted = rules.get(ax)
        wants_model = wanted == "model" or (
            isinstance(wanted, tuple) and "model" in wanted
        )
        has_model = ent == "model" or (
            isinstance(ent, tuple) and "model" in ent
        )
        if has_model:
            model_used = True
        if ax in _FALLBACK_TRIGGERS and wants_model and not has_model:
            lost = True
    if not lost or model_used:
        return spec

    # re-assign 'model' to the embed (fan) dim if it divides
    for i, (ax, ent, dim) in enumerate(zip(axes, entries, shape)):
        if ax == _FALLBACK_TARGET and ent is None and \
                dim % _axes_size(mesh, "model") == 0:
            entries[i] = "model"
            break
    return Spec(*entries)


def zero1_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO-1: add the data axes to the first shardable replicated dim.

    Optimizer state (fp32 master + moments) is elementwise in the update,
    so it can shard over (pod, data) on top of TP: reduce-scatter(grads) ->
    sharded update -> all-gather(params), the standard ZeRO-1 schedule.
    """
    daxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not daxes:
        return spec
    dsize = _axes_size(mesh, daxes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(a in ("pod", "data") or
           (isinstance(a, tuple) and any(x in ("pod", "data") for x in a))
           for a in entries if a):
        return spec
    for i, (ent, dim) in enumerate(zip(entries, shape)):
        if ent is None and dim % dsize == 0:
            entries[i] = daxes if len(daxes) > 1 else daxes[0]
            break
    return Spec(*entries)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def map_tree(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of trees of one structure: nested dicts
    and namedtuples, whose leaves are anything else (an axes tuple counts
    as one leaf)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, *vals)
                            for vals in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_specs(axes_tree: Any, abstract_tree: Any, mesh,
               rules: ShardingRules) -> Any:
    """Map (axes tree, tensor tree of the same structure) -> Spec tree;
    only the tensors' shapes are read."""
    return map_tree(
        lambda ax, ab: spec_for_decl(rules, tuple(ax), tuple(ab.shape), mesh),
        axes_tree, abstract_tree)


def zero_specs(specs: Any, abstract_tree: Any, mesh) -> Any:
    """:func:`zero1_spec` over a Spec tree."""
    return map_tree(lambda s, ab: zero1_spec(s, tuple(ab.shape), mesh),
                    specs, abstract_tree)


def train_state_shardings(state_axes: Any, state_abs: Any, mesh,
                          rules: ShardingRules, zero1: bool = True,
                          zero3: bool = False) -> Any:
    """Specs for a TrainState: params per rules; optimizer state with ZeRO-1
    (data-axes) sharding layered on top; zero3 additionally shards the
    parameters themselves over the data axes (per-layer all-gather)."""
    base = tree_specs(state_axes, state_abs, mesh, rules)
    if not zero1 and not zero3:
        return base
    opt = dict(base.opt)
    for key in ("mu", "nu", "master"):
        if key in opt:
            opt[key] = zero_specs(opt[key], state_abs.opt[key], mesh)
    params = base.params
    if zero3:
        params = zero_specs(base.params, state_abs.params, mesh)
    return base._replace(opt=opt, params=params)
