"""Mamba-1 selective SSM block (the falcon-mamba and jamba mixer).

The counterpart of the reference's ``repro/models/mamba.py``: the same
parameters (``in_proj`` fused (x, z), a depthwise causal conv of
``cfg.ssm_conv`` taps, ``x_proj`` to (dt_rank, B, C), ``dt_proj`` with the
inverse-softplus ``dt_bias``, the S4D ``a_log`` = log(1..d_state), the
``d_skip`` D, ``out_proj``), the same inputs to the recurrence
h_t = a_t * h_{t-1} + b_t (a_t = exp(dt_t A), A diagonal), and the same
decode state: the trailing K - 1 inputs of the conv, before the conv, and
h, float32 whatever the model dtype.

The recurrence runs over chunks of ``cfg.ssm_chunk`` tokens with h carried
from chunk to chunk, as in the reference; within a chunk it is a doubling
(Hillis-Steele) scan of the same combine the reference's
``associative_scan`` applies, log2(chunk) passes over (B, chunk, d_inner,
d_state) tensors, never a step a token.  The summation order differs from
the reference's (ROADMAP.md section 3), within the float tolerance.  The
last chunk may be shorter, so nothing is padded and nothing can leak into
the carried state.  Under autograd each chunk is recomputed in the
backward pass (the reference's ``jax.checkpoint``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.declare import DeclTree, ParamDecl


def _a_log_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    # S4D-real init: A = -(1..d_state) per channel, for any leading axes
    # (the stacked (layers, di, st) declaration too); draws nothing
    a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                     device=generator.device).expand(shape)
    return torch.log(a).to(dtype).contiguous()


def _dt_bias_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    # dt in [1e-3, 1e-1], log-uniform, through the inverse softplus
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return torch.log(torch.expm1(dt)).to(dtype)


def mamba_decls(cfg: ModelConfig) -> DeclTree:
    d, di, st, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {
        "in_proj": ParamDecl((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamDecl((cfg.ssm_conv, di), ("conv_kernel", "ssm_inner"),
                            "fan_in", scale=1.0),
        "conv_b": ParamDecl((di,), ("ssm_inner",), "zeros"),
        "x_proj": ParamDecl((di, dtr + 2 * st), ("ssm_inner", None)),
        "dt_proj": ParamDecl((dtr, di), ("dt_rank", "ssm_inner"),
                             scale=dtr ** -0.5),
        "dt_bias": ParamDecl((di,), ("ssm_inner",), "custom",
                             custom=_dt_bias_init, dtype="float32"),
        "a_log": ParamDecl((di, st), ("ssm_inner", "ssm_state"), "custom",
                           custom=_a_log_init, dtype="float32"),
        "d_skip": ParamDecl((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamDecl((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over the sequence.  x: (B, L, di); w: (K, di).
    The sum of K shifted slices, in tap order, as the reference."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + l] * w[i]
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(params: Dict, xc: torch.Tensor, cfg: ModelConfig):
    """Per token (a, bx, C) from the conv output xc (..., di): a and bx
    (..., di, st) and C (..., st), float32."""
    dtr, st = cfg.dt_rank, cfg.ssm_state
    proj = xc @ params["x_proj"].to(xc.dtype)
    dt_raw, b_in, c_in = torch.split(proj, [dtr, st, st], dim=-1)
    dt = _softplus((dt_raw @ params["dt_proj"].to(xc.dtype)).float()
                   + params["dt_bias"].float())              # (..., di)
    a_mat = -torch.exp(params["a_log"].float())              # (di, st)
    a = torch.exp(dt[..., None] * a_mat)
    bx = (dt * xc.float())[..., None] * b_in.float()[..., None, :]
    return a, bx, c_in.float()


def _scan_chunk(h0: torch.Tensor, a: torch.Tensor, bx: torch.Tensor
                ) -> torch.Tensor:
    """h over one chunk: a, bx (B, L, di, st), h0 (B, di, st) -> (B, L, di,
    st).  A doubling scan: after the pass at stride s, element t holds the
    combine of elements t - 2s + 1 .. t, combine((a1, b1), (a2, b2)) =
    (a1 a2, a2 b1 + b2) with the earlier element first.  Without autograd
    the tails update in place (a and bx are this chunk's own
    temporaries); under it each pass makes new tensors, which the backward
    pass needs."""
    n = a.shape[1]
    in_place = not torch.is_grad_enabled()
    s = 1
    while s < n:
        if in_place:
            bx[:, s:] += a[:, s:] * bx[:, :-s]
            a[:, s:] = a[:, s:] * a[:, :-s]
        else:
            bx = torch.cat([bx[:, :s], a[:, s:] * bx[:, :-s] + bx[:, s:]],
                           dim=1)
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a * h0[:, None] + bx


def _chunk_body(params: Dict, h0: torch.Tensor, xc: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (h at its last token, y (B, L, di) float32)."""
    a, bx, c_in = _ssm_inputs(params, xc, cfg)
    h = _scan_chunk(h0, a, bx)
    return h[:, -1], torch.einsum("blis,bls->bli", h, c_in)


def mamba_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Training / prefill forward.  x: (B, L, d) -> (B, L, d).

    ``return_state=True`` also returns (conv_state (B, K-1, di) in the
    model dtype, ssm_state (B, di, st) float32) for decode, from the same
    pass.
    """
    b, l, _ = x.shape
    di, dt = cfg.d_inner, x.dtype
    xz = x @ params["in_proj"].to(dt)
    xs, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_causal_conv(xs, params["conv_w"].to(dt),
                             params["conv_b"].to(dt)).float()).to(dt)

    chunk = min(cfg.ssm_chunk, l)
    recompute = torch.is_grad_enabled() and xc.requires_grad
    h = torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for start in range(0, l, chunk):
        args = (params, h, xc[:, start:start + chunk], cfg)
        h, yc = (checkpoint(_chunk_body, *args, use_reentrant=False)
                 if recompute else _chunk_body(*args))
        ys.append(yc)
    y = torch.cat(ys, dim=1) + params["d_skip"].float() * xc.float()
    y = y.to(dt) * F.silu(z.float()).to(dt)
    out = y @ params["out_proj"].to(dt)
    if return_state:
        k1 = cfg.ssm_conv - 1   # the trailing K-1 conv inputs (zeros before)
        conv_state = F.pad(xs, (0, 0, k1, 0))[:, -k1:] if k1 else xs[:, :0]
        return out, conv_state, h
    return out


def mamba_decode_step(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One token.  x: (B, 1, d); conv_state (B, K-1, di) the trailing conv
    inputs; ssm_state (B, di, st) float32.  Returns (y (B, 1, d),
    conv_state, ssm_state), the states new tensors."""
    di, dt = cfg.d_inner, x.dtype
    xz = x @ params["in_proj"].to(dt)
    xs, z = xz[..., :di], xz[..., di:]                 # (B, 1, di)
    window = torch.cat([conv_state.to(dt), xs], dim=1)  # (B, K, di)
    xc = (window * params["conv_w"].to(dt)).sum(1) + params["conv_b"].to(dt)
    xc = F.silu(xc.float()).to(dt)                      # (B, di)
    a, bx, c_in = _ssm_inputs(params, xc, cfg)          # (B, di, st), (B, st)
    ssm_state = a * ssm_state + bx
    y = torch.einsum("bis,bs->bi", ssm_state, c_in)
    y = y + params["d_skip"].float() * xc.float()
    y = y.to(dt) * F.silu(z[:, 0].float()).to(dt)
    out = y @ params["out_proj"].to(dt)
    return out[:, None, :], window[:, 1:], ssm_state
