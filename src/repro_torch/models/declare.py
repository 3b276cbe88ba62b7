"""Declarative parameters: one declaration drives init and layout.

Each parameter is declared once with (shape, logical axes, init), as in the
reference (``repro/models/declare.py``).  From the same tree of
declarations the port derives the initialised tensors
(:func:`repro_torch.models.lm.init_params`), the decode cache and the
logical-axes tree, and the abstract tree of the dry-run (:func:`abstract_tree`:
tensors on the meta device, which hold a shape and a dtype and no
storage).  A leaf may carry its own dtype (the Mamba
mixer's ``a_log`` and ``dt_bias`` stay float32 in a bfloat16 model) and a
``custom`` init, as in the reference.

Trees are nested dicts; they are walked in sorted key order, the order
``jax.tree_util`` flattens a dict in, so the n-th draw of a generator
initialises the same leaf in both packages' walk order (the numbers differ:
``torch.Generator`` is not ``jax.random``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "fan_in"              # fan_in | normal | zeros | ones | custom
    scale: float = 1.0
    custom: Any = None                # callable(generator, shape, dtype)
    dtype: Optional[str] = None       # overrides the model dtype (e.g.
                                      # "float32" for sensitive params)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")

    def resolve_dtype(self, model_dtype: torch.dtype) -> torch.dtype:
        return getattr(torch, self.dtype) if self.dtype else model_dtype


DeclTree = Dict[str, Any]  # nested dicts of ParamDecl


def tree_map(fn: Callable[[ParamDecl], Any], decls: DeclTree) -> Dict[str, Any]:
    """Apply ``fn`` to every declaration, keeping the dict structure."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in sorted(decls.items())}


def init_tree(generator: torch.Generator, decls: DeclTree,
              dtype: torch.dtype, device: torch.device | str) -> Dict[str, Any]:
    """Initialised tensors for ``decls`` on ``device``.

    Random leaves draw from ``generator`` (which must live on ``device``) in
    sorted key order, in float32, then cast to the leaf's dtype (its own, or
    ``dtype``): the same generator state gives the same values at any model
    dtype, rounded.  A leaf of more than ``DRAW_CHUNK`` elements is drawn in
    pieces of that many, so the float32 draw of a full-width expert stack
    never holds the whole leaf a second time.
    """
    return tree_map(lambda d: _init_one(generator, d, dtype, device), decls)


DRAW_CHUNK = 1 << 28


def _init_one(generator: torch.Generator, d: ParamDecl, dtype: torch.dtype,
              device) -> torch.Tensor:
    dtype = d.resolve_dtype(dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "custom":
        return d.custom(generator, d.shape, dtype).to(device)
    if d.init == "normal":
        std = d.scale
    elif d.init == "fan_in":
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        # stacked layer params: leading "layers" axis is not fan-in
        if d.axes and d.axes[0] == "layers" and len(d.shape) > 1:
            fan_in = math.prod(d.shape[1:-1]) or d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {d.init!r}")
    # drawn flat in pieces: a leaf of one piece gets the values a draw of
    # its shape would
    out = torch.empty(d.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW_CHUNK):
        part = torch.randn(min(DRAW_CHUNK, flat.numel() - start),
                           generator=generator, dtype=torch.float32,
                           device=device)
        flat[start:start + part.numel()] = part.mul_(std)
    return out


def axes_tree(decls: DeclTree) -> Dict[str, Any]:
    return tree_map(lambda d: d.axes, decls)


def abstract_tree(decls: DeclTree, dtype: torch.dtype) -> Dict[str, Any]:
    """Meta tensors of each leaf's shape and resolved dtype (its own, or
    ``dtype``): the reference's ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.resolve_dtype(dtype),
                                          device="meta"), decls)


def stack_layers(decl: ParamDecl, n: int) -> ParamDecl:
    """Prepend the stacked ('layers') axis to a declaration."""
    return dataclasses.replace(
        decl, shape=(n, *decl.shape), axes=("layers", *decl.axes)
    )
