"""Mixture-of-Experts FFN: top-k token-choice routing, sort-based dispatch.

The counterpart of the reference's ``repro/models/moe.py``, with its
routing and its drops at capacity:

- tokens route in groups of ``cfg.moe_chunk`` a batch row (one group a row
  when the length does not divide), with a capacity per group and expert
  (:func:`capacity`, rounded up to 8; ``no_drop`` sizes it for every
  choice);
- the router runs in float32: softmax, top-k, and the chosen weights
  renormalised over the chosen experts; the Switch load-balance loss over
  the top-1 choice is returned for the trainer;
- the dispatch sorts each row's (token, choice) pairs by expert id
  (``argsort(stable=True)``), numbers them within their expert by a count
  and a cumulative sum, keeps those below capacity, and fills a dense
  (E, capacity, d) buffer; dropped choices ride the residual;
- the expert products are one batched product over the expert axis.

Two rules the reference leaves to its library are fixed here (ROADMAP.md
section 3):

- ties in the router's top-k go to the lower expert id, the order
  ``jax.lax.top_k`` gives (:func:`_top_k`; ``torch.topk`` promises none);
- the combine gathers each token's k expert outputs and adds them in
  ascending expert id, one add after another: no scatter-add, so two runs
  on the card give the same bits;
- so does the backward pass: every row move of the dispatch and the
  combine is a :class:`_Rows`, whose gradient is a gather too, and a
  token's gradient from its k slots is added in ascending expert id, the
  combine's order (a gather's own backward is a float scatter-add, whose
  atomics add a token's k terms in whatever order they land).

Under autograd, when a row has more than one group, each group is
recomputed in the backward pass (the reference's per-group
``jax.checkpoint``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.declare import DeclTree, ParamDecl


def moe_decls(cfg: ModelConfig) -> DeclTree:
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    decls: DeclTree = {
        "router": ParamDecl((d, e), ("embed", "expert"), scale=0.1),
        "w_up": ParamDecl((e, d, f), ("expert", "embed", "ff")),
        "w_down": ParamDecl((e, f, d), ("expert", "ff", "embed")),
    }
    if cfg.act == "swiglu":
        decls["w_gate"] = ParamDecl((e, d, f), ("expert", "embed", "ff"))
    return decls


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


def grouping(cfg: ModelConfig, seq: int, no_drop: bool) -> Tuple[int, int]:
    """(group, capacity) for a row of ``seq`` tokens: groups of
    ``cfg.moe_chunk`` tokens (the whole row when that does not divide it),
    and each expert's capacity in a group."""
    k = cfg.top_k
    group = seq if not cfg.moe_chunk else min(cfg.moe_chunk, seq)
    if seq % group != 0:
        group = seq  # one group a row
    cap = max(8, -(-group * k // 8) * 8) if no_drop else capacity(cfg, group)
    return group, min(cap, group * k)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, largest first, ties to the lower
    index (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(params: Dict, x: torch.Tensor, cfg: ModelConfig):
    """(probs (B, S, E), weights (B, S, k), ids (B, S, k)), all float32
    but the int64 ids; weights renormalised over the chosen experts."""
    logits = x.float() @ params["router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = _top_k(probs, cfg.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_ids


def aux_loss(probs: torch.Tensor, top_ids: torch.Tensor, n_experts: int
             ) -> torch.Tensor:
    """Switch's load-balance loss over the top-1 choice, float32 ()."""
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_ids[..., 0], n_experts).float().mean(dim=(0, 1))
    return n_experts * torch.sum(me * ce)


class Dispatch(NamedTuple):
    """One group's dispatch, per batch row.

    ``src`` (B, E, cap): the token filling each expert slot; ``choice``
    (B, E, cap): which of that token's choices it is; ``filled`` (B, E,
    cap): whether a token fills the slot; ``slot`` (B, G, k): each choice's
    slot in the flattened (E * cap) buffer, E * cap when dropped; ``keep``
    (B, G, k): whether each choice was kept.  Choices (k) are in the
    router's order, largest weight first.
    """
    src: torch.Tensor
    choice: torch.Tensor
    filled: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor


def dispatch(ids: torch.Tensor, n_experts: int, cap: int) -> Dispatch:
    """The reference's sort-based dispatch for ids (B, G, k).

    The (token, choice) pairs of a row are sorted by expert id, stably, so
    an expert takes its tokens in token order; each pair's position in its
    expert comes from the counts' exclusive cumulative sum; pairs at or
    past capacity are dropped.
    """
    b, g, k = ids.shape
    e = n_experts
    dev = ids.device
    flat_e = ids.reshape(b, g * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = counts.cumsum(1) - counts
    pos = torch.arange(g * k, device=dev) - starts.gather(1, se)
    keep_sorted = pos < cap
    slot_sorted = torch.where(keep_sorted, se * cap + pos,
                              torch.full_like(se, e * cap))
    # back to (token, choice) order: each pair's slot and keep
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    # each expert slot's token: the sorted pair at starts[e] + c
    c = torch.arange(cap, device=dev)
    filled = c < counts[..., None]
    at = (starts[..., None] + c).clamp(max=g * k - 1).reshape(b, e * cap)
    pair = order.gather(1, at).reshape(b, e, cap)
    return Dispatch(src=pair // k, choice=pair % k, filled=filled,
                    slot=slot.reshape(b, g, k), keep=keep.reshape(b, g, k))


def _experts(params: Dict, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, E, C, d) -> (B, E, C, d): every expert's FFN on its slots, as
    one batched product over the expert axis."""
    dt = buf.dtype
    b, e, c, d = buf.shape
    xe = buf.transpose(0, 1).reshape(e, b * c, d)
    up = torch.bmm(xe, params["w_up"].to(dt))
    if cfg.act == "swiglu":
        gate = torch.bmm(xe, params["w_gate"].to(dt))
        h = F.silu(gate.float()).to(dt) * up
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(up.float(), approximate="tanh").to(dt)
    y = torch.bmm(h, params["w_down"].to(dt))
    return y.reshape(e, b, c, d).transpose(0, 1)


def _pick(src: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor
          ) -> torch.Tensor:
    """Row ``idx[b, i]`` of ``src`` (B, R, d) where ``ok[b, i]``, zero
    elsewhere: (B, N, d).  A masked index may be R, the sentinel of a
    dropped choice (the zero row the reference appends)."""
    b, r, d = src.shape
    idx = idx.reshape(b, -1, 1).clamp(max=r - 1).expand(-1, -1, d)
    rows = src.gather(1, idx)
    return torch.where(ok.reshape(b, -1, 1), rows,
                       torch.zeros((), dtype=src.dtype, device=src.device))


class _Rows(torch.autograd.Function):
    """:func:`_pick` under autograd with a backward of gathers and adds in
    a fixed order, no float atomics: row r of the input's gradient is the
    sum over j, added in j order one add after another, of the output
    gradient's row ``back[b, r, j]`` where ``back_ok[b, r, j]``.  ``back``
    (B, R, m) is the transpose of ``idx``: every output row (b, i) with
    ``ok`` stands in it once, at row ``idx[b, i]``; any other entry is
    masked, or is the sentinel N."""

    @staticmethod
    def forward(ctx, src, idx, ok, back, back_ok):
        ctx.save_for_backward(back, back_ok)
        return _pick(src, idx, ok)

    @staticmethod
    def backward(ctx, grad):
        back, back_ok = ctx.saved_tensors
        b, r, m = back.shape
        parts = _pick(grad, back, back_ok).reshape(b, r, m, -1)
        out = parts[:, :, 0]
        for j in range(1, m):
            out = out + parts[:, :, j]
        return out, None, None, None, None


def _group(params: Dict, x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
           cfg: ModelConfig, cap: int) -> torch.Tensor:
    """One dispatch group across the batch: (B, G, d) -> (B, G, d)."""
    b, g, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = e * cap
    plan = dispatch(ids, e, cap)
    # each token's choices in ascending expert id: the order of every sum
    # over them, forward and backward; ``at`` numbers them t * k + j
    by_expert = torch.argsort(ids, dim=-1)
    slot = plan.slot.gather(2, by_expert).reshape(b, g * k)
    keep = plan.keep.gather(2, by_expert).reshape(b, g * k)
    base = torch.arange(g, device=x.device)[:, None] * k
    at = (base + torch.argsort(by_expert, dim=-1)).reshape(b, g * k)
    # the pair filling each slot, numbered as ``at`` numbers it
    src, filled = plan.src.reshape(b, n), plan.filled.reshape(b, n)
    pair = at.gather(1, (src * k + plan.choice.reshape(b, n)))
    # dispatch: a token's gradient is the sum over its kept slots
    buf = _Rows.apply(x, src, filled, slot.reshape(b, g, k),
                      keep.reshape(b, g, k))
    y = _experts(params, buf.reshape(b, e, cap, d), cfg).reshape(b, n, d)
    # combine: each filled slot's gradient is its one pair's
    contrib = _Rows.apply(y, slot, keep, pair[..., None],
                          filled[..., None])
    # the router weights in the same order (a dropped choice's
    # contribution is already zero)
    every = torch.ones_like(keep)
    wk = _Rows.apply(w.to(x.dtype).reshape(b, g * k, 1),
                     (base + by_expert).reshape(b, g * k), every,
                     at[..., None], every[..., None])
    contrib = contrib.reshape(b, g, k, d) * wk.reshape(b, g, k, 1)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out


def moe_ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
            no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss () float32).

    ``no_drop=True`` sizes capacity for every choice, so no token is
    dropped: the serving semantics of decode.  Otherwise choices past an
    expert's capacity in their group ride the residual (training, forward
    and prefill), so forward and decode logits can differ at saturated
    experts, as in the reference.
    """
    b, s, d = x.shape
    group, cap = grouping(cfg, s, no_drop)
    probs, top_p, top_ids = route(params, x, cfg)
    aux = aux_loss(probs, top_ids, cfg.n_experts)
    n_groups = s // group
    if n_groups == 1:
        return _group(params, x, top_ids, top_p, cfg, cap), aux
    recompute = torch.is_grad_enabled() and x.requires_grad
    outs = []
    for i in range(n_groups):
        sl = slice(i * group, (i + 1) * group)
        args = (params, x[:, sl], top_ids[:, sl], top_p[:, sl], cfg, cap)
        outs.append(checkpoint(_group, *args, use_reentrant=False)
                    if recompute else _group(*args))
    return torch.cat(outs, dim=1), aux


def routing(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
            no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """What :func:`moe_ffn` decides for ``x``: the router's top-k ids and
    whether each choice was kept, both (B, S, k), choices largest first."""
    b, s, _ = x.shape
    group, cap = grouping(cfg, s, no_drop)
    _probs, _top_p, top_ids = route(params, x, cfg)
    keep = torch.cat([dispatch(top_ids[:, i:i + group], cfg.n_experts,
                               cap).keep for i in range(0, s, group)], dim=1)
    return top_ids, keep
