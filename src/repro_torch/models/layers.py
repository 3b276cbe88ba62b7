"""Model primitives: norms, RoPE, GQA attention, MLPs.

The counterpart of the reference's ``repro/models/layers.py``.  Parameters
are plain dicts of tensors declared through :mod:`repro_torch.models.declare`
under the reference's key names and shapes.  The reference's ``lshard``
sharding annotations are a no-op on one device and have no counterpart.

Full-sequence attention has two routes (:func:`attention`):

- under autograd (grad mode on and q, k or v requiring grad, i.e.
  training), the reference's own training attention, :func:`_sdpa` and the
  query-chunked :func:`_sdpa_chunked`: einsum and softmax in plain PyTorch,
  which autograd differentiates.  The reference trains through this XLA
  attention, not through its Pallas kernel, and has no backward kernel;
- otherwise (forward and prefill in inference) the hand-written flash
  kernel (:func:`repro_torch.kernels.attention.ops.flash_attention`; its
  plain version on CPU tensors), which refuses inputs that need a gradient
  on the card rather than return a result autograd cannot see through.

One-token decode attention is plain PyTorch, as the reference computes it
in XLA and not in a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, switch
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.models.declare import DeclTree, ParamDecl

# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def norm_decls(cfg: ModelConfig) -> DeclTree:
    if cfg.norm == "nonparam_ln":
        return {}  # OLMo: non-parametric LayerNorm — no learned scale/bias
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDecl((cfg.d_model,), ("embed",), "ones"),
            "bias": ParamDecl((cfg.d_model,), ("embed",), "zeros"),
        }
    return {"scale": ParamDecl((cfg.d_model,), ("embed",), "ones")}


def apply_norm(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * params["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        xc = xf - mean
        out = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6)
        if cfg.norm == "layernorm":
            out = out * params["scale"].float() + params["bias"].float()
        # nonparam_ln: no affine (OLMo, arXiv:2402.00838)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions: (..., d_head/2), float32."""
    half = cfg.d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python-scalar base: no host-to-device copy, which would synchronise
    # the stream once per layer
    inv = 1.0 / torch.pow(cfg.rope_theta, exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:               # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal)
# ---------------------------------------------------------------------------


def attention_decls(cfg: ModelConfig) -> DeclTree:
    d, hd = cfg.d_model, cfg.d_head
    h, kv = cfg.n_heads_padded, cfg.n_kv_heads_padded
    return {
        "wq": ParamDecl((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDecl((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDecl((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDecl((h, hd, d), ("heads", "head_dim", "embed")),
    }


def _head_mask(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Zero the padded heads' contribution (exact published semantics)."""
    if cfg.n_heads_padded == cfg.n_heads:
        return x
    mask = torch.arange(cfg.n_heads_padded, device=x.device) < cfg.n_heads
    return x * mask[None, None, :, None].to(x.dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, heads, D) -> (B, S, heads, D)."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.to(x.dtype).reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) x (H, D, d) -> (B, S, d)."""
    b, s, h, hd = o.shape
    return (o.reshape(b * s, h * hd) @ wo.to(o.dtype).reshape(h * hd, -1)
            ).reshape(b, s, -1)


def _qkv(params: Dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    """q, k, v, RoPE on q and k unless ``cfg.rope`` is False (attention
    with no position embedding, as Jamba's)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if not switch(cfg, "rope"):
        return q, k, v
    cos, sin = rope_freqs(cfg, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each kv head H/KV times."""
    kvh = k.shape[2]
    return k if kvh == n_heads else k.repeat_interleave(n_heads // kvh, dim=2)


def _sdpa(q, k, v, cfg: ModelConfig, *, causal_offset: int = 0):
    """Scaled-dot-product attention, causal, GQA via repeat-KV.

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D).  Queries at absolute position
    causal_offset + i attend to keys at positions <= that.  Scores and
    softmax in float32, the probabilities cast to q's dtype before the sum
    over v, as the reference's ``_sdpa``.  The products q.k are taken in
    q's dtype and widened after (on bf16 the score is rounded to bf16 where
    the reference keeps float32; exact in float32).
    """
    b, sq, h, dh = q.shape
    kf = _repeat_kv(k, h)
    vf = _repeat_kv(v, h)
    scores = torch.einsum("bqhd,bshd->bhqs", q, kf).float() / math.sqrt(dh)
    qpos = torch.arange(sq, device=q.device) + causal_offset
    kpos = torch.arange(kf.shape[1], device=q.device)
    mask = kpos[None, :] <= qpos[:, None]  # (Sq, Sk)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, vf)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, chunk: int):
    """Query-chunked attention: query blocks in turn, so the live score
    buffer is (B, H, chunk, Sk) instead of (B, H, Sq, Sk)."""
    sq = q.shape[1]
    if sq % chunk:
        raise ValueError(f"sequence {sq} is not a multiple of the attention "
                         f"chunk {chunk}")
    return torch.cat([_sdpa(q[:, i:i + chunk], k, v, cfg, causal_offset=i)
                      for i in range(0, sq, chunk)], dim=1)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def attention_prefill(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor):
    """Full-sequence causal attention; returns (y, k, v) so prefill can
    keep K and V for the decode cache.

    The flash kernel's route (inference).  Padded heads are masked before
    the output projection, here and in decode.
    """
    q, k, v = _qkv(params, x, cfg, positions)
    out = _head_mask(cfg, flash_attention(q, k, v, causal=True))
    return _out_proj(out, params["wo"]), k, v


def attention(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (training/prefill) attention.

    Under autograd it takes the reference's training attention (query
    chunks of ``cfg.attn_chunk`` when the sequence is longer); otherwise the
    flash kernel (:func:`attention_prefill`).
    """
    q, k, v = _qkv(params, x, cfg, positions)
    if not _needs_grad(q, k, v):
        out = flash_attention(q, k, v, causal=True)
    elif cfg.attn_chunk and x.shape[1] > cfg.attn_chunk:
        out = _sdpa_chunked(q, k, v, cfg, cfg.attn_chunk)
    else:
        out = _sdpa(q, k, v, cfg)
    return _out_proj(_head_mask(cfg, out), params["wo"])


def attention_decode(
    params: Dict,
    x: torch.Tensor,            # (B, 1, d)
    cfg: ModelConfig,
    k_cache: torch.Tensor,      # (B, S, KV, D), written in place
    v_cache: torch.Tensor,
    pos: int,                   # current position
):
    """One-token decode against a KV cache; returns (y, k_cache, v_cache).

    Unlike the reference, which returns updated copies, the new K and V are
    written into the caches in place (and the same tensors returned): a copy
    of the whole cache per token would move the cache twice per step.
    Attention reads the positions written so far, <= ``pos``, which is what
    the reference's -1e30 mask over the whole cache leaves.
    """
    pos = int(pos)
    positions = torch.full((x.shape[1],), pos, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)

    h, dh = q.shape[2], q.shape[3]
    kf = _repeat_kv(k_cache[:, :pos + 1], h)
    vf = _repeat_kv(v_cache[:, :pos + 1], h)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kf.float()
                          ) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, vf.to(q.dtype))
    out = _head_mask(cfg, out)
    return _out_proj(out, params["wo"]), k_cache, v_cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_decls(cfg: ModelConfig, d_ff: Optional[int] = None) -> DeclTree:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamDecl((d, f), ("embed", "ff")),
            "w_up": ParamDecl((d, f), ("embed", "ff")),
            "w_down": ParamDecl((f, d), ("ff", "embed")),
        }
    return {
        "w_up": ParamDecl((d, f), ("embed", "ff")),
        "w_down": ParamDecl((f, d), ("ff", "embed")),
    }


def mlp(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.act == "swiglu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        h = F.silu(g.float()).to(dt) * u
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu((x @ params["w_up"].to(dt)).float(),
                   approximate="tanh").to(dt)
    return h @ params["w_down"].to(dt)
