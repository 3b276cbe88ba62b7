"""Public wrapper around the flash-attention kernel (``csrc/attention.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel on the current stream or raises — there is no fallback.
``flash_attention.launches`` counts kernel launches (plain runs do not
count), so a run can show that its main path went through the kernel.

Unlike the reference's wrapper (``repro/kernels/attention/ops.py``), which
repeats the KV heads, transposes to (B*H, S, D) and pads S to the block
size, the kernel reads q, k and v in their (B, S, heads, D) layout through
strides and maps query head h to KV head h // (H / KV) itself: no copy.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             *[_L] * 12, ctypes.c_float, _I, _P],
                            ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.library("attention", _SIGNATURES)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Sk, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head width")
    kv = k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not divide into {kv} KV heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head width {d} outside 1..{MAX_HEAD_DIM}")
    if k.shape[1] < 1:
        raise ValueError("need at least one key")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride along D, got "
                             f"strides {t.stride()}")
    if b * h > 65535 or max(sq, sk) >= 2**31:
        raise ValueError(f"shape too large for one launch: B*H={b * h}, "
                         f"Sq={sq}, Sk={sk}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0 or b * h == 0:
        return out
    lib = _lib()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, kv, sq, sk, d, *strides,
            1.0 / math.sqrt(d), int(causal), stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward: softmax(q k^T / sqrt(D)) v per head.

    Args:
      q: (B, Sq, H, D) float32 or bfloat16 (computed in float32).
      k, v: (B, Sk, KV, D), same dtype and device; H % KV == 0 and query
        head h reads KV head h // (H / KV).
      causal: mask the keys after each query (key position > query
        position, both counted from 0).
    Returns:
      (B, Sq, H, D) in q's dtype.
    """
    _check_inputs(q, k, v)
    if q.is_cuda:
        return _launch(q, k, v, causal)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    raise ValueError(f"unsupported device {q.device}")


flash_attention.launches = 0
