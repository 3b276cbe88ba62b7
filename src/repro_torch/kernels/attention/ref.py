"""Plain PyTorch version of the flash-attention kernel (causal, GQA).

The counterpart of the reference's oracle (``repro/kernels/attention/ref.py``):
float32 scores ``q.k / sqrt(D)``, keys after the query masked to -1e30,
softmax, the weighted sum of the values in float32, output in q's dtype.
CPU tensors take this version; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernels against it on the card,
elementwise and by :func:`block_error`.
"""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor,   # (B, Sq, H, D)
                  k: torch.Tensor,   # (B, Sk, KV, D)
                  v: torch.Tensor,
                  *,
                  causal: bool = True,
                  causal_offset: int = 0) -> torch.Tensor:
    """(B, Sq, H, D).  H % KV == 0; query head h reads KV head h // (H/KV).

    With ``causal``, the query at position ``causal_offset + i`` attends to
    the keys at positions <= that.
    """
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    group = h // k.shape[2]
    kf = k.repeat_interleave(group, dim=2) if group > 1 else k
    vf = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kf.float()) / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device) + causal_offset
        kpos = torch.arange(kf.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, vf.float()).to(q.dtype)


def block_error(out: torch.Tensor, ref: torch.Tensor, block: int = 128
                ) -> float:
    """Largest ``||out - ref||_F / ||ref||_F`` over the blocks of ``block``
    consecutive query rows of one (b, h) of two (B, S, H, D) outputs.

    At long rows an output element is small (about ``sqrt(e / keys)`` for
    unit scores), so an elementwise tolerance such as bf16's 3e-2 can pass
    a fault that moves only some rows or key tiles by a few percent; the
    relative norm of the block holding them cannot.
    """
    b, sq, h, d = out.shape
    pad = -sq % block
    diff = torch.nn.functional.pad(out.float() - ref.float(),
                                   (0, 0, 0, 0, 0, pad))
    full = torch.nn.functional.pad(ref.float(), (0, 0, 0, 0, 0, pad))
    num = diff.view(b, -1, block, h, d).square().sum((2, 4))
    den = full.view(b, -1, block, h, d).square().sum((2, 4))
    return float((num / den.clamp_min(torch.finfo(torch.float32).tiny))
                 .sqrt().max())
