"""Modality frontend stubs for the vlm and audio backbones.

The counterpart of the reference's ``repro/models/frontends.py``.  The
transformer backbone is what is specified; the modality frontend supplies
precomputed patch or frame embeddings:

- internvl2-26b (vlm): the real frontend is InternViT-6B producing patch
  embeddings projected to d_model; here a (batch, prefix_len, d_model)
  embedding tensor arrives as an input (prefix_len = 256 patches an image).
- musicgen-medium (audio): the real frontend is EnCodec; the backbone is a
  decoder over EnCodec tokens (vocab 2048) with a conditioning prefix of
  (batch, prefix_len, d_model) frame embeddings (prefix_len = 64).

The prefix embeddings are concatenated ahead of the token embeddings; the
loss and decode operate on token positions only (see :mod:`.lm`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


def prefix_embed_shape(cfg: ModelConfig, batch: int
                       ) -> Optional[Tuple[int, int, int]]:
    if cfg.frontend == "none" or cfg.prefix_len == 0:
        return None
    return (batch, cfg.prefix_len, cfg.d_model)


def synthetic_prefix(generator: torch.Generator, cfg: ModelConfig,
                     batch: int, dtype: torch.dtype = torch.bfloat16
                     ) -> Optional[torch.Tensor]:
    """Standard normal x 0.02 on the generator's device: drawn in float32,
    cast to ``dtype``, then scaled, as the reference does; None for an arch
    with no frontend.
    """
    shape = prefix_embed_shape(cfg, batch)
    if shape is None:
        return None
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return draw.to(dtype) * 0.02
