"""The dense decoder: forward, prefill and one-token decode.

The counterpart of the reference's ``repro/models/lm.py`` for the dense
family (attention mixer, dense FFN, no frontend).  Parameters for one period
of ``cfg.pattern`` are stacked over ``cfg.n_groups`` under the reference's
key names and shapes; the port walks the stack with a plain Python loop
over views of it (``stacked[g]``), so under autograd each layer's gradient
flows back into the stacked leaves.  Training recomputes each layer group
in the backward pass as ``cfg.remat`` says (:func:`_remat`).  A Mamba
mixer, an MoE FFN or a frontend raises ``NotImplementedError``: those wait
for ROADMAP.md queue 1 item 4.

Entry points:
- :func:`hidden_forward` — final normed hidden states (training, under
  autograd; the loss takes logits chunk by chunk through :func:`unembed`)
- :func:`forward`       — logits over the whole sequence (+ aux loss, 0)
- :func:`prefill_step`  — forward over the prompt AND build the decode cache
- :func:`decode_step`   — one-token step against the cache (in place)
- :func:`init_params`   — synthetic weights from a ``torch.Generator``
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import declare
from repro_torch.models.declare import DeclTree, ParamDecl
from repro_torch.models.layers import (
    apply_norm,
    attention,
    attention_decls,
    attention_decode,
    attention_prefill,
    mlp,
    mlp_decls,
    norm_decls,
)

DecodeCache = Dict[str, Any]
NOT_PORTED = "waits for ROADMAP.md queue 1 item 4"


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: the dense family only."""
    for mixer, ff in cfg.pattern:
        if mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: the {mixer!r} mixer {NOT_PORTED}")
        if ff not in ("dense", None):
            raise NotImplementedError(
                f"{cfg.name}: the {ff!r} FFN {NOT_PORTED}")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------


def _sub_decls(cfg: ModelConfig, ff: Optional[str]) -> DeclTree:
    d: DeclTree = {"norm1": norm_decls(cfg), "attn": attention_decls(cfg)}
    if ff == "dense":
        d["norm2"] = norm_decls(cfg)
        d["mlp"] = mlp_decls(cfg)
    return d


def model_decls(cfg: ModelConfig) -> DeclTree:
    check_supported(cfg)
    group: DeclTree = {f"sub_{i}": _sub_decls(cfg, ff)
                       for i, (_mixer, ff) in enumerate(cfg.pattern)}
    decls: DeclTree = {
        "embed": ParamDecl((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"),
                           "normal", scale=0.02),
        "layers": declare.tree_map(
            lambda p: declare.stack_layers(p, cfg.n_groups), group),
        "final_norm": norm_decls(cfg),
    }
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl(
            (cfg.d_model, cfg.vocab_padded), ("embed", "vocab")
        )
    return decls


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str = "cuda") -> Dict:
    """Synthetic weights on ``device``, drawn from ``generator`` (which must
    live on that device)."""
    return declare.init_tree(generator, model_decls(cfg), model_dtype(cfg),
                             device)


def param_axes(cfg: ModelConfig) -> Dict:
    return declare.axes_tree(model_decls(cfg))


def _layer(stacked: Dict, g: int) -> Dict:
    """Layer ``g``'s slice of the stacked params (or cache): views."""
    return {k: _layer(v, g) if isinstance(v, dict) else v[g]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Embedding and head
# ---------------------------------------------------------------------------


def _embed_tokens(params: Dict, tokens: torch.Tensor, cfg: ModelConfig):
    return params["embed"][tokens].to(model_dtype(cfg))


def _logits(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d) -> (B, S, vocab_padded) float32; padded vocab at -1e30.

    The product runs in float32 on the model-dtype values: the reference's
    float32 accumulation with a float32 result.
    """
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.float() @ head.to(x.dtype).float()
    if cfg.vocab_padded != cfg.vocab:
        # mask padded vocab columns: exact published-model semantics
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn(sub: Dict, h: torch.Tensor, cfg: ModelConfig, ff: Optional[str]):
    if ff is None:
        return h
    return h + mlp(sub["mlp"], apply_norm(sub.get("norm2", {}), h, cfg), cfg)


def _group_body(gp: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    """One period of ``cfg.pattern``: attention + FFN sub-layers."""
    for i, (_mixer, ff) in enumerate(cfg.pattern):
        sub = gp[f"sub_{i}"]
        hn = apply_norm(sub.get("norm1", {}), x, cfg)
        x = x + attention(sub["attn"], hn, cfg, positions)
        x = _ffn(sub, x, cfg, ff)
    return x


# The products "dots" remat keeps: matmuls with no batch dims (the
# projections and the MLP), as the reference's
# checkpoint_dots_with_no_batch_dims; the attention einsums (bmm) and every
# element-wise pass are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` wrapped for the backward pass as ``cfg.remat`` says: "none"
    keeps every activation; "full" keeps only the group's inputs and
    recomputes the rest; "dots" keeps the projection products too.

    The dense pattern has one sub-layer a group, so the reference's nested
    remat of heterogeneous groups (period > 1) has nothing to nest here.
    """
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def hidden_forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final normed hidden states (B, S, d), aux_loss ()).

    Differentiable: under autograd, gradients reach the stacked layer
    leaves through the views ``stacked[g]``.
    """
    check_supported(cfg)
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    body = _remat(_group_body, cfg)
    for g in range(cfg.n_groups):
        x = body(_layer(params["layers"], g), x, cfg, positions)
    x = apply_norm(params.get("final_norm", {}), x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, vocab_padded) f32, aux_loss ())."""
    x, aux = hidden_forward(params, tokens, cfg)
    return _logits(params, x, cfg), aux


def unembed(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Public logits head (used by the chunked loss)."""
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


def cache_decls(cfg: ModelConfig, batch: int, max_seq: int) -> DeclTree:
    check_supported(cfg)
    kv_shape = (batch, max_seq, cfg.n_kv_heads_padded, cfg.d_head)
    axes = ("batch", "seq_kv", "kv_heads", "head_dim")
    group = {f"sub_{i}": {"k": ParamDecl(kv_shape, axes, "zeros"),
                          "v": ParamDecl(kv_shape, axes, "zeros")}
             for i in range(cfg.period)}
    return declare.tree_map(lambda p: declare.stack_layers(p, cfg.n_groups),
                            group)


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device: torch.device | str = "cuda") -> DecodeCache:
    """Zeroed K/V caches in the model dtype: (n_groups, B, max_seq, KV, D)."""
    return declare.tree_map(
        lambda d: torch.zeros(d.shape, dtype=model_dtype(cfg), device=device),
        cache_decls(cfg, batch, max_seq))


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(params: Dict, cache: DecodeCache, tokens: torch.Tensor,
                pos: int, cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeCache]:
    """One-token decode.  Returns (logits (B, 1, vocab_padded), cache).

    ``tokens`` is (B, 1); ``pos`` the position being written.  The cache is
    updated in place and returned.  Inference only: runs under
    ``torch.no_grad()``, so trained weights (autograd leaves) decode too.
    """
    check_supported(cfg)
    x = _embed_tokens(params, tokens, cfg)
    for g in range(cfg.n_groups):
        gp, gc = _layer(params["layers"], g), _layer(cache, g)
        for i, (_mixer, ff) in enumerate(cfg.pattern):
            sub, sc = gp[f"sub_{i}"], gc[f"sub_{i}"]
            hn = apply_norm(sub.get("norm1", {}), x, cfg)
            y, _k, _v = attention_decode(sub["attn"], hn, cfg, sc["k"],
                                         sc["v"], pos)
            x = _ffn(sub, x + y, cfg, ff)
    x = apply_norm(params.get("final_norm", {}), x, cfg)
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Prefill (forward + cache construction)
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_step(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 max_seq: Optional[int] = None
                 ) -> Tuple[torch.Tensor, DecodeCache]:
    """Forward over the prompt, returning (last-position logits, cache).

    The cache is sized ``max_seq`` (>= prompt length) so decode can continue
    in place; attention caches the full K/V prefix.  Prefill attention is
    the flash kernel followed by the padded-head mask, the same attention
    as :func:`forward` (the reference's prefill leaves the mask out; see
    ROADMAP.md section 3).  Inference only: runs under ``torch.no_grad()``,
    which keeps the flash kernel's route for trained weights.
    """
    check_supported(cfg)
    b, seq = tokens.shape
    max_seq = max_seq or seq
    if max_seq < seq:
        raise ValueError(f"max_seq {max_seq} < prompt length {seq}")
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(seq, dtype=torch.int32, device=x.device)
    cache = init_decode_cache(cfg, b, max_seq, device=x.device)
    for g in range(cfg.n_groups):
        gp, gc = _layer(params["layers"], g), _layer(cache, g)
        for i, (_mixer, ff) in enumerate(cfg.pattern):
            sub, sc = gp[f"sub_{i}"], gc[f"sub_{i}"]
            hn = apply_norm(sub.get("norm1", {}), x, cfg)
            y, k, v = attention_prefill(sub["attn"], hn, cfg, positions)
            sc["k"][:, :seq] = k
            sc["v"][:, :seq] = v
            x = _ffn(sub, x + y, cfg, ff)
    x = apply_norm(params.get("final_norm", {}), x, cfg)
    return _logits(params, x[:, -1:, :], cfg), cache
