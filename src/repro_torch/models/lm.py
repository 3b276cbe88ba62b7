"""The unified decoder: every arch the port runs is an instance of it.

The counterpart of the reference's ``repro/models/lm.py``.  One period of
``cfg.pattern`` is a run of sub-layers, each an attention or Mamba mixer
and an optional dense or MoE FFN; the period's parameters are stacked over
``cfg.n_groups`` under the reference's key names and shapes.  The port
walks the stack with a plain Python loop over views of it (``stacked[g]``),
so under autograd each layer's gradient flows back into the stacked leaves.
Training recomputes each layer group in the backward pass as ``cfg.remat``
says (:func:`_remat`), and with "full" each sub-layer of a longer period
too.  A stub frontend's embeddings (:mod:`.frontends`) go ahead of the
tokens, with positions over the whole sequence.

Entry points:
- :func:`hidden_forward` — final normed hidden states (training, under
  autograd; the loss takes logits chunk by chunk through :func:`unembed`)
- :func:`forward`       — logits over the whole sequence (+ the MoE aux loss)
- :func:`prefill_step`  — forward over the prompt AND build the decode cache
- :func:`decode_step`   — one-token step against the cache (in place)
- :func:`init_params`   — synthetic weights from a ``torch.Generator``
- :func:`abstract_params`, :func:`abstract_decode_cache` — the same trees
  as meta tensors, for the dry-run (``launch/dryrun.py``)
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
from repro_torch.models.mamba import mamba_block, mamba_decls, mamba_decode_step
from repro_torch.models.moe import moe_decls, moe_ffn
from repro_torch.runtime import spans

DecodeCache = Dict[str, Any]


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------


def _sub_decls(cfg: ModelConfig, mixer: str, ff: Optional[str]) -> DeclTree:
    d: DeclTree = {"norm1": norm_decls(cfg)}
    if mixer == "attn":
        d["attn"] = attention_decls(cfg)
    else:
        d["mamba"] = mamba_decls(cfg)
    if ff == "dense":
        d["norm2"] = norm_decls(cfg)
        d["mlp"] = mlp_decls(cfg)
    elif ff == "moe":
        d["norm2"] = norm_decls(cfg)
        d["moe"] = moe_decls(cfg)
    return d


def model_decls(cfg: ModelConfig) -> DeclTree:
    group: DeclTree = {f"sub_{i}": _sub_decls(cfg, mixer, ff)
                       for i, (mixer, ff) in enumerate(cfg.pattern)}
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


def abstract_params(cfg: ModelConfig) -> Dict:
    """The params tree as meta tensors (shapes and dtypes, no storage)."""
    return declare.abstract_tree(model_decls(cfg), model_dtype(cfg))


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


def _embed(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
           prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings, with a stub frontend's (B, P, d) ahead of them."""
    x = _embed_tokens(params, tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _ffn(sub: Dict, h: torch.Tensor, cfg: ModelConfig, ff: Optional[str], *,
         no_drop: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """h plus the sub-layer's FFN, and the MoE aux loss (None otherwise)."""
    if ff is None:
        return h, None
    hn = apply_norm(sub.get("norm2", {}), h, cfg)
    if ff == "dense":
        return h + mlp(sub["mlp"], hn, cfg), None
    y, aux = moe_ffn(sub["moe"], hn, cfg, no_drop=no_drop)
    return h + y, aux


def _apply_sub(sub: Dict, x: torch.Tensor, cfg: ModelConfig, idx: int,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sub-layer: (x, aux () float32)."""
    mixer, ff = cfg.pattern[idx]
    h = apply_norm(sub.get("norm1", {}), x, cfg)
    if mixer == "attn":
        x = x + attention(sub["attn"], h, cfg, positions)
    else:
        x = x + mamba_block(sub["mamba"], h, cfg)
    x, aux = _ffn(sub, x, cfg, ff)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _group_body(gp: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One period of ``cfg.pattern``: (x, the period's aux sum)."""
    # nested remat: with "full", a period of several sub-layers (jamba's 8)
    # otherwise holds every sub-layer's recompute graph at once in the
    # backward pass
    nest = cfg.remat == "full" and cfg.period > 1 and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.period):
        args = (gp[f"sub_{i}"], x, cfg, i, positions)
        x, a = (checkpoint(_apply_sub, *args, use_reentrant=False) if nest
                else _apply_sub(*args))
        aux = aux + a
    return x, aux


# The products "dots" remat keeps: matmuls with no batch dims (the
# projections and the MLP), as the reference's
# checkpoint_dots_with_no_batch_dims; the attention einsums and the expert
# products (bmm) and every element-wise pass are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` wrapped for the backward pass as ``cfg.remat`` says: "none"
    keeps every activation; "full" keeps only the group's inputs and
    recomputes the rest (each sub-layer of the group under its own
    checkpoint too, :func:`_group_body`); "dots" keeps the projection
    products too."""
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


def hidden_forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                   prefix_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final normed hidden states (B, P + S, d), aux_loss ()).

    ``prefix_embeds`` (B, P, d), a stub frontend's, go ahead of the token
    embeddings.  Differentiable: under autograd, gradients reach the
    stacked layer leaves through the views ``stacked[g]``.
    """
    x = _embed(params, tokens, cfg, prefix_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    body = _remat(_group_body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        x, a = body(_layer(params["layers"], g), x, cfg, positions)
        aux = aux + a
    x = apply_norm(params.get("final_norm", {}), x, cfg)
    return x, aux


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, P + S, vocab_padded) f32, aux_loss ())."""
    x, aux = hidden_forward(params, tokens, cfg, prefix_embeds)
    return _logits(params, x, cfg), aux


def unembed(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Public logits head (used by the chunked loss)."""
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


def _sub_cache_decls(cfg: ModelConfig, mixer: str, batch: int,
                     max_seq: int) -> DeclTree:
    if mixer == "attn":
        kv_shape = (batch, max_seq, cfg.n_kv_heads_padded, cfg.d_head)
        axes = ("batch", "seq_kv", "kv_heads", "head_dim")
        return {"k": ParamDecl(kv_shape, axes, "zeros"),
                "v": ParamDecl(kv_shape, axes, "zeros")}
    return {
        "conv": ParamDecl((batch, cfg.ssm_conv - 1, cfg.d_inner),
                          ("batch", None, "ssm_inner"), "zeros"),
        # the recurrence's state stays float32 in any model dtype
        "ssm": ParamDecl((batch, cfg.d_inner, cfg.ssm_state),
                         ("batch", "ssm_inner", "ssm_state"), "zeros",
                         dtype="float32"),
    }


def cache_decls(cfg: ModelConfig, batch: int, max_seq: int) -> DeclTree:
    group = {f"sub_{i}": _sub_cache_decls(cfg, mixer, batch, max_seq)
             for i, (mixer, _ff) in enumerate(cfg.pattern)}
    return declare.tree_map(lambda p: declare.stack_layers(p, cfg.n_groups),
                            group)


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device: torch.device | str = "cuda") -> DecodeCache:
    """Zeroed caches, stacked over the groups: K/V (n_groups, B, max_seq,
    KV, D) in the model dtype for attention sub-layers; conv (n_groups, B,
    K-1, d_inner) in the model dtype and ssm (n_groups, B, d_inner,
    d_state) float32 for Mamba ones."""
    return declare.tree_map(
        lambda d: torch.zeros(d.shape, dtype=d.resolve_dtype(model_dtype(cfg)),
                              device=device),
        cache_decls(cfg, batch, max_seq))


def abstract_decode_cache(cfg: ModelConfig, batch: int,
                          max_seq: int) -> DecodeCache:
    """:func:`init_decode_cache`'s tree as meta tensors: the ssm state
    float32, the rest in the model dtype."""
    return declare.abstract_tree(cache_decls(cfg, batch, max_seq),
                                 model_dtype(cfg))


def cache_axes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    return declare.axes_tree(cache_decls(cfg, batch, max_seq))


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(params: Dict, cache: DecodeCache, tokens: torch.Tensor,
                pos: int, cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeCache]:
    """One-token decode.  Returns (logits (B, 1, vocab_padded), cache).

    ``tokens`` is (B, 1); ``pos`` the position being written.  The cache is
    updated in place and returned: K/V at ``pos``, and each Mamba
    sub-layer's conv and ssm states.  MoE routes without drops.  Counts
    the batch's tokens under ``lm.decode_tokens``.  Inference
    only: runs under ``torch.no_grad()``, so trained weights (autograd
    leaves) decode too.
    """
    spans.count("lm.decode_tokens", tokens.shape[0])
    x = _embed_tokens(params, tokens, cfg)
    for g in range(cfg.n_groups):
        gp, gc = _layer(params["layers"], g), _layer(cache, g)
        for i, (mixer, ff) in enumerate(cfg.pattern):
            sub, sc = gp[f"sub_{i}"], gc[f"sub_{i}"]
            hn = apply_norm(sub.get("norm1", {}), x, cfg)
            if mixer == "attn":
                y, _k, _v = attention_decode(sub["attn"], hn, cfg, sc["k"],
                                             sc["v"], pos)
            else:
                y, conv, ssm = mamba_decode_step(sub["mamba"], hn, cfg,
                                                 sc["conv"], sc["ssm"])
                sc["conv"].copy_(conv)
                sc["ssm"].copy_(ssm)
            x, _aux = _ffn(sub, x + y, cfg, ff, no_drop=True)
    x = apply_norm(params.get("final_norm", {}), x, cfg)
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Prefill (forward + cache construction)
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_step(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 max_seq: Optional[int] = None,
                 prefix_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, DecodeCache]:
    """Forward over the prompt, returning (last-position logits, cache).

    ``prefix_embeds`` (B, P, d) go ahead of the tokens, so the sequence is
    P + S long.  The cache is sized ``max_seq`` (>= that length) so decode
    can continue in place; attention caches the full K/V prefix, Mamba
    sub-layers the conv tail and the final h, from the same pass.  MoE
    drops at capacity, as in :func:`forward`, unless ``cfg.moe_dropless``.
    Counts the B·(P + S) positions under ``lm.prefill_tokens``.  Prefill
    attention is the flash kernel followed by the padded-head mask, the
    same attention as :func:`forward` (the reference's prefill leaves the
    mask out; see ROADMAP.md section 3).  Inference only: runs under
    ``torch.no_grad()``, which keeps the flash kernel's route for trained
    weights.
    """
    x = _embed(params, tokens, cfg, prefix_embeds)
    b, seq = x.shape[:2]
    max_seq = max_seq or seq
    if max_seq < seq:
        raise ValueError(f"max_seq {max_seq} < prompt length {seq}")
    spans.count("lm.prefill_tokens", b * seq)
    positions = torch.arange(seq, dtype=torch.int32, device=x.device)
    cache = init_decode_cache(cfg, b, max_seq, device=x.device)
    for g in range(cfg.n_groups):
        gp, gc = _layer(params["layers"], g), _layer(cache, g)
        for i, (mixer, ff) in enumerate(cfg.pattern):
            sub, sc = gp[f"sub_{i}"], gc[f"sub_{i}"]
            hn = apply_norm(sub.get("norm1", {}), x, cfg)
            if mixer == "attn":
                y, k, v = attention_prefill(sub["attn"], hn, cfg, positions)
                sc["k"][:, :seq] = k
                sc["v"][:, :seq] = v
            else:
                y, conv, ssm = mamba_block(sub["mamba"], hn, cfg,
                                           return_state=True)
                sc["conv"].copy_(conv)
                sc["ssm"].copy_(ssm)
            x, _aux = _ffn(sub, x + y, cfg, ff)
    x = apply_norm(params.get("final_norm", {}), x, cfg)
    return _logits(params, x[:, -1:, :], cfg), cache
