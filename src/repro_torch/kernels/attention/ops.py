"""Public wrapper around the flash-attention kernels.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
a kernel on the current stream or raises — there is no fallback.  Which
kernel is decided before the launch, from dtype, shape and strides alone
(:func:`_route`):

- ``"tc"``: ``csrc/flash_sm90.cu``, Hopper's tensor cores (``wgmma`` on
  bf16, TMA-staged tiles), for bf16 with D 64, 96 or 128 whose q, k and v
  meet TMA's alignment (16-byte base, strides multiples of 8 elements, unit
  stride along D);
- ``"simt"``: ``csrc/attention.cu``, fp32 arithmetic on the CUDA cores,
  for everything else (fp32, other head widths, unaligned views).

The kernels compute the forward only: on the card the wrapper raises on
inputs that need a gradient (training attention is ``models.layers._sdpa``).

``flash_attention.launches`` counts kernel launches (plain runs do not
count) and ``flash_attention.launches_by_route`` splits them by route, so a
run can show which kernel its main path went through.

A tensor on the meta device (the dry-run) takes the kernel's shape op
(:mod:`repro_torch.kernels.shape_ops`): an empty output, no launch
counted, and 4 D operations per (query, key) pair scored
(:func:`flash_flops`) counted as its FLOPs.

Unlike the reference's wrapper (``repro/kernels/attention/ops.py``), which
repeats the KV heads, transposes to (B*H, S, D) and pads S to the block
size, both kernels read q, k and v in their (B, S, heads, D) layout through
strides and map query head h to KV head h // (H / KV) themselves: no copy.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, shape_ops
from repro_torch.kernels.attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "flash_flops", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core kernel's head widths: whole 128-byte swizzled boxes (64,
# 128) or 64-byte ones (96, phi3-mini's)
_TC_HEAD_DIMS = (64, 96, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             *[_L] * 12, ctypes.c_float, _I, _P],
                            ctypes.c_int),
}


_TC_SIGNATURES = {
    "flash_sm90_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        *[_L] * 12, ctypes.c_float, _I, _P], ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.library("attention", _SIGNATURES)


def _tc_lib() -> ctypes.CDLL:
    return _build.library("flash_sm90", _TC_SIGNATURES)


def _tma_strides(t: torch.Tensor) -> list:
    """Element strides of dims 0-2 of a (B, S, heads, D) tensor as its TMA
    map takes them: a dim of size 1 has no meaningful stride, so it gets
    the one it would have if it were contiguous over the dims inside it."""
    strides = list(t.stride()[:3])
    inner = t.shape[3] * t.stride(3)
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            strides[i] = inner
        inner = strides[i] * t.shape[i]
    return strides


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tc"`` or ``"simt"``: which kernel takes these (valid) inputs.

    Reads dtype, shape, strides and base addresses only, so it runs on any
    device (the CPU tests call it on CPU tensors).
    """
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        return "simt"
    if q.shape[3] not in _TC_HEAD_DIMS:
        return "simt"
    for t in (q, k, v):
        if t.stride(3) != 1 or t.data_ptr() % 16:
            return "simt"
        if any(s <= 0 or s % 8 for s in _tma_strides(t)):
            return "simt"
    return "tc"


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
            causal: bool, route: str) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride along D, got "
                             f"strides {t.stride()}")
    if (route == "simt" and b * h > 65535) or max(sq, sk) >= 2**31:
        raise ValueError(f"shape too large for one launch: B*H={b * h}, "
                         f"Sq={sq}, Sk={sk}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0 or b * h == 0:
        return out
    scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "tc":
            lib = _tc_lib()
            strides = [s for t in (q, k, v) for s in _tma_strides(t)]
            err = lib.flash_sm90_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, kv, sq, sk, d, *strides, *out.stride()[:3], scale,
                int(causal), stream)
        else:
            lib = _lib()
            strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, h, kv, sq, sk, d, *strides, scale,
                int(causal), stream)
    _build.check(lib, err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


def scored_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a head scores: query i (from 0) sees keys 0..i
    when causal."""
    if not causal:
        return sq * sk
    full = min(sq, sk)
    return full * (full + 1) // 2 + (sq - full) * sk


def flash_flops(q_shape, k_shape, causal: bool) -> int:
    """The kernel's operations: q.k and p.v, 2 D each, per scored pair of
    every (batch, query head)."""
    b, sq, h, d = q_shape
    return 4 * d * b * h * scored_pairs(sq, k_shape[1], causal)


_shape_op = shape_ops.define(
    "flash_attention_shape",
    "(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
    lambda q, k, v, causal: torch.empty_like(q),
    lambda q, k, v, causal: flash_flops(q, k, causal))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward: softmax(q k^T / sqrt(D)) v per head.

    Args:
      q: (B, Sq, H, D) float32 or bfloat16 (scores, softmax and the sum
        in float32; the tensor-core route rounds the probabilities to
        bfloat16 before multiplying them into v).
      k, v: (B, Sk, KV, D), same dtype and device; H % KV == 0 and query
        head h reads KV head h // (H / KV).
      causal: mask the keys after each query (key position > query
        position, both counted from 0).
    Returns:
      (B, Sq, H, D) in q's dtype.

    The kernels have no backward: on a CUDA tensor, inputs that need a
    gradient (grad mode on and q, k or v requiring grad) raise rather than
    give a result that autograd cannot see through.  Training attention
    takes ``models.layers._sdpa`` instead.
    """
    _check_inputs(q, k, v)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError(
                "flash_attention has no backward; run it under "
                "torch.no_grad() or on inputs that need no gradient")
        return _launch(q, k, v, causal, _route(q, k, v))
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type == "meta":
        return _shape_op(q, k, v, causal)
    raise ValueError(f"unsupported device {q.device}")


flash_attention.launches = 0
flash_attention.launches_by_route = {"tc": 0, "simt": 0}
