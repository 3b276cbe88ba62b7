"""Train / prefill / serve steps.

The counterpart of the reference's ``repro/train/step.py``.  The steps are
what the launcher drives.  The cancellation/checkpoint machinery wraps them
at the host level and never reaches inside — the paper's "flag tested
between kernel executions" contract.

Differences from the reference, by design (ROADMAP.md queue 3):

- :class:`TrainState` is a ``NamedTuple`` (the checkpoint store walks
  namedtuples), its params are autograd leaves, and its ``rng`` is the
  state of a CPU ``torch.Generator`` (a uint8 tensor) where the reference
  keeps a ``jax.random`` key;
- the train step runs eagerly (no ``torch.compile``): the loss under
  autograd, then the in-place AdamW update
  (:func:`repro_torch.optim.adamw.adamw_update`), so ``train_step(state,
  batch)`` returns the same tensors it was given, updated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.models import lm
from repro_torch.models.frontends import prefix_embed_shape, synthetic_prefix
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Dict[str, Any]   # autograd leaves (requires_grad)
    opt: Dict[str, Any]      # mu, nu (fp32), count, master (non-fp32 models)
    step: torch.Tensor       # () int32, on the params' device
    rng: torch.Tensor        # state of a CPU torch.Generator (uint8)


def as_trainable(params: Dict) -> Dict:
    """Mark every param leaf as an autograd leaf (in place)."""
    return tree_map(lambda p: p.requires_grad_(True), params)


def _rng_state(seed: int) -> torch.Tensor:
    return torch.Generator().manual_seed(seed).get_state()


def init_train_state(seed: int, cfg: ModelConfig,
                     device: torch.device | str = "cuda") -> TrainState:
    """Fresh state: params from a generator on ``device`` seeded ``seed``,
    zero moments (and the fp32 master copy for a bf16 model), step 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = as_trainable(lm.init_params(gen, cfg, device=device))
    return TrainState(
        params=params,
        opt=adamw_init(params),
        step=torch.zeros((), dtype=torch.int32, device=device),
        rng=_rng_state(seed + 1),
    )


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """:func:`init_train_state`'s tree as meta tensors (the dry-run's
    argument): params, fp32 mu / nu (and master for a bf16 model), count
    and step.  ``rng`` is a CPU generator's state, as in the real state: a
    host tensor of a few kilobytes, which a step reads and replaces."""
    params = lm.abstract_params(cfg)
    return TrainState(
        params=params,
        opt=adamw_init(params),
        step=torch.empty((), dtype=torch.int32, device="meta"),
        rng=_rng_state(0),
    )


def train_state_axes(cfg: ModelConfig) -> TrainState:
    """Logical axes tree matching TrainState."""
    axes = lm.param_axes(cfg)
    opt = {"mu": axes, "nu": axes, "count": ()}
    if cfg.dtype == "bfloat16":
        opt["master"] = axes
    return TrainState(params=axes, opt=opt, step=(), rng=(None,))


def _advance(rng: torch.Tensor) -> torch.Tensor:
    """The generator state one draw later (the reference's fold_in)."""
    gen = torch.Generator()
    gen.set_state(rng.cpu())
    torch.empty((), dtype=torch.int64).random_(generator=gen)
    return gen.get_state()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked negative-log-likelihood sum, mask count) for one chunk.

    Max-shifted logsumexp; the label's logit by ``gather`` (the reference
    contracts a one-hot mask over the vocab for its sharded layout: on one
    device the same value).  The final position predicts the wrapped token
    (synthetic data), so it is masked.
    """
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    ll = label_logit - lse
    mask = torch.ones_like(ll)
    mask[:, -1] = 0.0
    return -torch.sum(ll * mask), torch.sum(mask)


def _chunk_terms(params: Dict, x: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig):
    return _ce_terms(lm.unembed(params, x, cfg), labels)


def loss_fn(
    params: Dict,
    tokens: torch.Tensor,     # (B, S_text) int64
    labels: torch.Tensor,     # (B, S_text) next-token targets
    cfg: ModelConfig,
    prefix_embeds: Optional[torch.Tensor] = None,   # (B, P, d) stub frontend
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, aux = lm.hidden_forward(params, tokens, cfg, prefix_embeds)
    x = x[:, -tokens.shape[1]:, :]  # prefix positions carry no labels
    b, s, d = x.shape

    nc = cfg.loss_chunk
    if nc and b % nc == 0 and b >= nc and nc > 1:
        # Chunked CE: the (B, S, vocab) f32 logits are never materialized;
        # each batch sub-chunk recomputes its logits in the backward pass.
        # Chunks are STRIDED (row = nc*j + i), as the reference's.
        bc = b // nc
        xr = x.reshape(bc, nc, s, d).transpose(0, 1)
        lr = labels.reshape(bc, nc, s).transpose(0, 1)
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(nc):
            n_i, c_i = checkpoint(_chunk_terms, params, xr[i], lr[i], cfg,
                                  use_reentrant=False)
            nll, cnt = nll + n_i, cnt + c_i
    else:
        nll, cnt = _ce_terms(lm.unembed(params, x, cfg), labels)

    ce = nll / torch.clamp(cnt, min=1.0)
    total = ce + cfg.router_aux_weight * aux
    return total, {"ce": ce, "aux": aux}


def loss_and_grads(params: Dict, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig):
    """(loss, parts, grads): one forward and backward over ``batch``
    (tokens, labels and, for a stub frontend, prefix_embeds); ``grads``
    mirrors ``params``."""
    loss, parts = loss_fn(params, batch["tokens"], batch["labels"], cfg,
                          batch.get("prefix_embeds"))
    flat = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return loss, parts, tree_map(lambda _: next(flat), params)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    schedule: Optional[Callable] = None):
    """(state, batch) -> (state, metrics).  batch: dict of tensors.

    metrics: loss, ce, aux (the MoE load-balance loss, 0 without MoE),
    grad_norm, lr — 0-d
    tensors on the state's device (read them with ``float()``).
    """
    schedule = schedule or (lambda s: 1.0)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, parts, grads = loss_and_grads(state.params, batch, cfg)
        lr_scale = schedule(state.step)
        params, opt, metrics = adamw_update(
            opt_cfg, state.params, grads, state.opt, lr_scale)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1,
                               rng=_advance(state.rng))
        metrics = dict(metrics, loss=loss.detach(),
                       **{k: v.detach() for k, v in parts.items()})
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: Optional[int] = None):
    """(params, batch) -> (last-token logits, decode cache)."""

    def prefill(params, batch: Dict[str, torch.Tensor]):
        return lm.prefill_step(params, batch["tokens"], cfg, max_seq=max_seq,
                               prefix_embeds=batch.get("prefix_embeds"))

    return prefill


def make_serve_step(cfg: ModelConfig):
    """(params, cache, tokens (B,1), pos) -> (logits, cache)."""

    def serve(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg)

    return serve


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int
                       ) -> Dict[str, torch.Tensor]:
    """One training batch as meta tensors (:func:`make_train_batch`'s
    shapes and dtypes): int64 tokens and labels of ``seq - cfg.prefix_len``
    positions and, for a stub frontend, bfloat16 prefix embeddings."""
    s_text = seq - cfg.prefix_len
    shapes = {
        "tokens": torch.empty((batch, s_text), dtype=torch.int64,
                              device="meta"),
        "labels": torch.empty((batch, s_text), dtype=torch.int64,
                              device="meta"),
    }
    pe = prefix_embed_shape(cfg, batch)
    if pe is not None:
        shapes["prefix_embeds"] = torch.empty(pe, dtype=torch.bfloat16,
                                              device="meta")
    return shapes


def make_train_batch(generator: torch.Generator, cfg: ModelConfig,
                     batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """A synthetic batch on the generator's device: tokens and labels of
    ``seq - cfg.prefix_len`` positions and, for a stub frontend, bfloat16
    prefix embeddings drawn after them from the same generator."""
    tb = synthetic_token_batch(generator, batch=batch,
                               seq=seq - cfg.prefix_len, vocab=cfg.vocab)
    out = {"tokens": tb.tokens, "labels": tb.labels}
    pe = synthetic_prefix(generator, cfg, batch)
    if pe is not None:
        out["prefix_embeds"] = pe
    return out
