"""AI21-Jamba2-Mini (Hugging Face ``model_type`` "jamba"), plainly.

The full causal forward of a Jamba stack over a token sequence, in
float32, with no cache, no batching tricks and no kernel: a sequential
selective scan, a loop over the experts and the tokens routed to each,
and attention written out (no SDPA) with no position embedding.  It
follows ``JambaForCausalLM``'s equations as published with the model:

- a layer is attention where ``l % attn_layer_period ==
  attn_layer_offset``, else Mamba; its FFN is the mixture of experts
  where ``l % expert_layer_period == expert_layer_offset``, else a dense
  SwiGLU; each is ``x + mixer(rmsnorm(x))`` then ``x + ffn(rmsnorm(x))``;
- Mamba-1: ``in_proj`` to (x, z); a depthwise causal conv of
  ``mamba_d_conv`` taps with a bias, then SiLU; ``x_proj`` to (dt, B, C);
  RMSNorms with weights on dt, B and C; ``dt_proj`` with its bias, then
  softplus; h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, A = -exp(A_log);
  y_t = C_t . h_t + D x_t; ``out_proj(y * silu(z))``;
- attention: GQA with no position embedding, softmax(q k^T / sqrt(D))
  under a causal mask;
- the router: a softmax over all the experts, the top
  ``num_experts_per_tok`` weights used as they are (not renormalised);
  each expert ``down(silu(gate(x)) * up(x))``;
- RMSNorm: x / sqrt(mean(x^2) + rms_norm_eps) times its weight;
- an untied ``lm_head`` after the final norm.

Departures: everything is float32 where the model runs in bf16; the
products run with TF32 off (``allow_tf32`` False for matmul and cuDNN);
a layer's weights are cast to float32 only while it runs (an expert's
one expert at a time), so the reference fits beside the bf16 model.

The weights are ``JambaForCausalLM``'s state dict as published, a flat
dict of its names (``model.embed_tokens.weight``, ``model.layers.<i>.
mamba.in_proj.weight``, ``...feed_forward.experts.<e>.gate_proj.weight``,
``lm_head.weight``, ...) in its shapes (linear weights (out, in)), as
``portbench/generators/jamba.py:draw`` makes them; the sizes come from
the configuration's published keys, never from the program.

``precision="fp8"`` rounds both inputs of every product (projections,
scores and probabilities, the router, the experts, the head) to e4m3
with one scale a tensor (its largest magnitude to 448): the control in
the precision below bf16 that a correctness check has to fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import torch

# Time steps of the scan's inputs worked out at once.
SCAN_BLOCK = 256
E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to e4m3 at one scale for the tensor."""
    amax = float(t.abs().max())
    if amax == 0.0 or not math.isfinite(amax):
        return t
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


class _Ops:
    """The products, in float32 or with fp8 inputs."""

    def __init__(self, precision: str) -> None:
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.low:
            a, b = fp8(a), fp8(b)
        return a @ b


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _w(w: Dict, name: str) -> torch.Tensor:
    return w[name].float()


def attention(w: Dict, p: str, h: torch.Tensor, cfg: dict, ops: _Ops
              ) -> torch.Tensor:
    """Causal GQA over (B, S, d), no position embedding, a head at a
    time; ``p`` the layer's ``self_attn.`` prefix."""
    b, s, d = h.shape
    nh, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    flat = h.reshape(b * s, d)
    q = ops.mm(flat, _w(w, p + "q_proj.weight").t()).reshape(b, s, nh, hd)
    k = ops.mm(flat, _w(w, p + "k_proj.weight").t()).reshape(b, s, kvh, hd)
    v = ops.mm(flat, _w(w, p + "v_proj.weight").t()).reshape(b, s, kvh, hd)
    future = torch.triu(torch.ones(s, s, dtype=torch.bool, device=h.device),
                        diagonal=1)
    out = torch.empty((b, s, nh, hd), dtype=torch.float32, device=h.device)
    for i in range(nh):
        j = i // (nh // kvh)
        scores = ops.mm(q[:, :, i], k[:, :, j].transpose(1, 2)) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
        out[:, :, i] = ops.mm(probs, v[:, :, j])
        del scores, probs
    return ops.mm(out.reshape(b * s, nh * hd),
                  _w(w, p + "o_proj.weight").t()).reshape(b, s, d)


def mamba(w: Dict, p: str, h: torch.Tensor, cfg: dict, ops: _Ops
          ) -> torch.Tensor:
    """Mamba-1 over (B, S, d) with Jamba's dt, B and C norms, the scan a
    time step after another; ``p`` the layer's ``mamba.`` prefix."""
    b, s, d = h.shape
    eps = cfg["rms_norm_eps"]
    dtr, st = cfg["mamba_dt_rank"], cfg["mamba_d_state"]
    di = cfg["mamba_expand"] * d
    xz = ops.mm(h.reshape(b * s, d), _w(w, p + "in_proj.weight").t())
    xz = xz.reshape(b, s, 2 * di)
    x, z = xz[..., :di], xz[..., di:]
    conv_w = _w(w, p + "conv1d.weight")[:, 0]               # (di, K)
    kt = conv_w.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, kt - 1, 0))
    conv = _w(w, p + "conv1d.bias").expand(b, s, di).clone()
    for i in range(kt):
        conv += xp[:, i:i + s] * conv_w[:, i]
    x = torch.nn.functional.silu(conv)
    del xz, xp, conv
    proj = ops.mm(x.reshape(b * s, di), _w(w, p + "x_proj.weight").t())
    dt, bm, cm = torch.split(proj.reshape(b, s, -1), [dtr, st, st], dim=-1)
    dt = rmsnorm(dt, w[p + "dt_layernorm.weight"], eps)
    bm = rmsnorm(bm, w[p + "b_layernorm.weight"], eps)
    cm = rmsnorm(cm, w[p + "c_layernorm.weight"], eps)
    dt = ops.mm(dt.reshape(b * s, dtr), _w(w, p + "dt_proj.weight").t())
    dt = torch.nn.functional.softplus(dt.reshape(b, s, di)
                                      + _w(w, p + "dt_proj.bias"))
    a = -torch.exp(_w(w, p + "A_log"))                      # (di, st)
    hs = torch.zeros((b, di, st), dtype=torch.float32, device=h.device)
    y = torch.empty((b, s, di), dtype=torch.float32, device=h.device)
    for t0 in range(0, s, SCAN_BLOCK):
        t1 = min(s, t0 + SCAN_BLOCK)
        da = torch.exp(dt[:, t0:t1, :, None] * a)          # (B, T, di, st)
        dbx = (dt[:, t0:t1] * x[:, t0:t1])[..., None] * bm[:, t0:t1, None, :]
        states = torch.empty_like(da)
        for t in range(t1 - t0):
            hs = torch.addcmul(dbx[:, t], da[:, t], hs)
            states[:, t] = hs
        y[:, t0:t1] = (states * cm[:, t0:t1, None, :]).sum(-1)
        del da, dbx, states
    y = (y + x * _w(w, p + "D")) * torch.nn.functional.silu(z)
    return ops.mm(y.reshape(b * s, di),
                  _w(w, p + "out_proj.weight").t()).reshape(b, s, d)


def _swiglu(x: torch.Tensor, w: Dict, p: str, ops: _Ops) -> torch.Tensor:
    """``p``'s ``down_proj(silu(gate_proj(x)) * up_proj(x))``."""
    g = ops.mm(x, _w(w, p + "gate_proj.weight").t())
    u = ops.mm(x, _w(w, p + "up_proj.weight").t())
    return ops.mm(torch.nn.functional.silu(g) * u,
                  _w(w, p + "down_proj.weight").t())


def moe(w: Dict, p: str, h: torch.Tensor, cfg: dict, ops: _Ops
        ) -> torch.Tensor:
    """Top-k of a softmax over all experts, weights as they are, each
    expert on the tokens routed to it; ``p`` the ``feed_forward.``
    prefix."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    probs = torch.softmax(ops.mm(x, _w(w, p + "router.weight").t()), dim=-1)
    weight, chosen = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        rows, which = torch.nonzero(chosen == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(x[rows], w, f"{p}experts.{e}.", ops)
        out.index_add_(0, rows, y * weight[rows, which, None])
    return out.reshape(b, s, d)


def dense(w: Dict, p: str, h: torch.Tensor, ops: _Ops) -> torch.Tensor:
    b, s, d = h.shape
    return _swiglu(h.reshape(b * s, d), w, p, ops).reshape(b, s, d)


def logits(weights: Dict, tokens: torch.Tensor, cfg: dict,
           positions: Sequence[int], precision: str = "fp32"
           ) -> torch.Tensor:
    """The forward over ``tokens`` (B, S): float32 logits (B,
    len(positions), vocab_size) at ``positions``."""
    ops = _Ops(precision)
    eps = cfg["rms_norm_eps"]
    w = weights
    with no_tf32(), torch.no_grad():
        x = w["model.embed_tokens.weight"][tokens].float()
        for layer in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{layer}."
            h = rmsnorm(x, w[p + "input_layernorm.weight"], eps)
            if (layer % cfg["attn_layer_period"]
                    == cfg["attn_layer_offset"]):
                x = x + attention(w, p + "self_attn.", h, cfg, ops)
            else:
                x = x + mamba(w, p + "mamba.", h, cfg, ops)
            h = rmsnorm(x, w[p + "pre_ff_layernorm.weight"], eps)
            if (layer % cfg["expert_layer_period"]
                    == cfg["expert_layer_offset"]):
                x = x + moe(w, p + "feed_forward.", h, cfg, ops)
            else:
                x = x + dense(w, p + "feed_forward.", h, ops)
            del h
        x = rmsnorm(x[:, list(positions)], w["model.final_layernorm.weight"],
                    eps)
        b, n, d = x.shape
        head = _w(w, "lm_head.weight").t()
        return ops.mm(x.reshape(b * n, d), head).reshape(b, n, -1)
