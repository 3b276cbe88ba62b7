"""The plain twin of the Mamba mixer's selective-scan kernel
(``csrc/selective_scan.cu``).

:func:`selective_scan_ref` walks the sequence a token at a time, as the
kernel does, in float32: per token ``a = exp(dt A)``, ``bx = (dt x) B``
(``models/mamba.py:_ssm_inputs``' rounding order), ``h = a h + bx``, and
``y = sum_s h_s C_s + D x`` with the sum over states in the kernel's
order: each of ``SCAN_LANES`` lanes adds its ``ceil(st / SCAN_LANES)``
states in order, then the lanes add by an xor tree.  The kernel contracts
its multiply-adds where this rounds twice, so the two agree to fp32
rounding, not bit for bit.  On the CPU it is what the wrapper runs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# The kernel's form (csrc/selective_scan.cu, read back by its
# selective_scan_form entry before the first launch): threads a block,
# lanes sharing a channel, and the most states a channel keeps in
# registers.
SCAN_THREADS = 128
SCAN_LANES = 4
SCAN_MAX_STATE = 16


def states_a_lane(st: int) -> int:
    """States each of a channel's lanes keeps: ceil(st / SCAN_LANES)."""
    return -(-st // SCAN_LANES)


def selective_scan_ref(xc: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y f32 (B, L, di), h f32 (B, di, st) at the last token) of the
    recurrence from h = 0.

    Args:
      xc: (B, L, di) the conv output, in the model's dtype.
      dt: (B, L, di) float32, after the softplus.
      b, c: (B, L, st) float32.
      a: (di, st) float32, A = -exp(a_log).
      d: (di,) float32, the skip D.
    """
    bsz, length, di = xc.shape
    st = a.shape[1]
    ns = states_a_lane(st)
    pad = ns * SCAN_LANES - st
    xf = xc.float()
    dx = dt * xf
    h = torch.zeros((bsz, di, st), dtype=torch.float32, device=xc.device)
    y = torch.empty((bsz, length, di), dtype=torch.float32,
                    device=xc.device)
    for t in range(length):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + dx[:, t, :, None] * b[:, t, None, :])
        p = F.pad(h * c[:, t, None, :], (0, pad)).view(bsz, di, SCAN_LANES,
                                                       ns)
        q = p[..., 0]
        for j in range(1, ns):
            q = q + p[..., j]
        y[:, t] = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
    return y + d * xf, h
