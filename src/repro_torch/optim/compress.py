"""Gradient compression for the DP all-reduce (distributed-optimization trick).

The counterpart of the reference's ``repro/optim/compress.py``.  Two codecs:

- int8 uniform quantization with per-leaf scale: a sum of int32-accumulated
  int8 payloads (8x wire compression, unbiased with stochastic rounding);
- top-k sparsification with error feedback: only the k largest-|g| entries
  travel; the residual is fed back next step (memory = one grads-sized
  buffer, standard Deep-Gradient-Compression shape).

:func:`compressed_psum_int8` runs over the port's single-controller
:class:`repro_torch.core.distributed.Mesh`: one gradient tree per shard in,
their mean out on the mesh's first device.  Only int8 payloads and one
scale per leaf and shard cross devices.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch

from repro_torch.core.distributed import Mesh, _check_axis
from repro_torch.tree import tree_map


def int8_encode(g: torch.Tensor, generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization.  Returns (q, scale).

    The rounding noise is drawn from ``generator`` (on ``g``'s device).
    """
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_encode(g: torch.Tensor, frac: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the top-|g| fraction.  Returns (values, indices, residual)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.topk(torch.abs(flat), k).indices
    kept = flat[idx]
    residual = flat.clone()
    residual[idx] = 0.0
    return kept, idx, residual.reshape(g.shape)


def topk_decode(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    flat = torch.zeros((math.prod(shape),), dtype=vals.dtype,
                       device=vals.device)
    return flat.index_add_(0, idx, vals).reshape(shape)


def compressed_psum_int8(mesh: Mesh, grads: Sequence[Any],
                         axes: Tuple[str, ...] = ("data",)) -> Any:
    """All-reduce-mean gradients over the mesh with an int8 wire format.

    ``grads[i]`` is shard ``i``'s gradient tree, on ``mesh.devices[i]``.
    Each leaf: the shards' scales (max |g| / 127) meet on the first device
    and the largest is shared, so payloads are commensurate; each shard
    rounds ``g / scale`` to int8, the payloads are summed in int32 on the
    first device (exact, in any order) and decoded with the shared scale
    over the shard count.  Wire bytes: 1/4 of fp32 plus one scalar per leaf.
    """
    for axis in axes:
        _check_axis(mesh, axis)
    if len(grads) != mesh.size:
        raise ValueError(f"{len(grads)} gradient trees for a mesh of "
                         f"{mesh.size} shards")
    dev0 = mesh.devices[0]
    n = mesh.size

    def reduce(*shard_leaves):
        gs = [g.to(torch.float32) for g in shard_leaves]
        scale = torch.stack([(torch.max(torch.abs(g)) + 1e-12).to(dev0)
                             for g in gs]).max() / 127.0
        total = torch.zeros(gs[0].shape, dtype=torch.int32, device=dev0)
        for g in gs:
            q = torch.clamp(torch.round(g / scale.to(g.device)), -127, 127)
            total += q.to(torch.int8).to(dev0)
        return total.to(torch.float32) * scale / n

    return tree_map(reduce, grads[0], *grads[1:])


__all__ = ["int8_encode", "int8_decode", "topk_encode", "topk_decode",
           "compressed_psum_int8"]
