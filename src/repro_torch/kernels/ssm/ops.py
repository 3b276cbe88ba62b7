"""Public wrapper around the Mamba mixer's selective-scan kernel.

:func:`selective_scan` runs the prefill's recurrence ``h = exp(dt A) h +
(dt x) B`` and its contraction ``y = h . C + D x`` in one pass over the
sequence (``csrc/selective_scan.cu``): the states stay in registers, and
nothing of shape (..., d_inner, d_state) reaches device memory.  It always
starts from h = 0, as a prefill does, and returns the states at the last
token for decode.  ``models/mamba.py`` routes a prefill to it on the card
without autograd for d_state <= ``SCAN_MAX_STATE``.

A CPU tensor takes the plain twin (:func:`selective_scan_ref`); a CUDA
tensor launches the kernel on the current stream or raises: there is no
fallback.  The kernel has no backward.  ``selective_scan.launches`` counts
its launches, as does the program counter ``selective_scan.launches``
(``runtime.spans.count``) while a profiler records; the launch sits in
the span ``repro_torch.kernels.selective_scan``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm.ref import (
    SCAN_LANES,
    SCAN_MAX_STATE,
    SCAN_THREADS,
    selective_scan_ref,
)
from repro_torch.runtime import spans

__all__ = ["selective_scan", "selective_scan_ref", "SCAN_MAX_STATE"]

SPAN = "repro_torch.kernels.selective_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# grid.y is the batch
_MAX_BATCH = 65535

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "selective_scan": ([_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                        _P], ctypes.c_int),
    "selective_scan_form": ([_P], None),
}

_checked = False


def _lib() -> ctypes.CDLL:
    """The library, its form held once to the plain model's
    (``ref.SCAN_*``)."""
    global _checked
    lib = _build.library("selective_scan", _SIGNATURES)
    if not _checked:
        form = (ctypes.c_int * 3)()
        lib.selective_scan_form(form)
        want = (SCAN_THREADS, SCAN_LANES, SCAN_MAX_STATE)
        if tuple(form) != want:
            raise RuntimeError(f"selective_scan_form says (threads, lanes, "
                               f"states) = {tuple(form)}, the plain model "
                               f"{want}")
        _checked = True
    return lib


def _check(xc, dt, b, c, a, d) -> None:
    if xc.dim() != 3:
        raise ValueError(f"need xc (B, L, d_inner), got {tuple(xc.shape)}")
    bsz, length, di = xc.shape
    st = a.shape[-1] if a.dim() == 2 else -1
    want = {"dt": (dt, (bsz, length, di)), "b": (b, (bsz, length, st)),
            "c": (c, (bsz, length, st)), "a": (a, (di, st)), "d": (d, (di,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, need "
                             f"{shape} for xc {tuple(xc.shape)}")
    if not 1 <= st <= SCAN_MAX_STATE:
        raise ValueError(f"d_state {st}: the scan keeps 1 to "
                         f"{SCAN_MAX_STATE} states a channel")
    if min(bsz, length, di) < 1 or bsz > _MAX_BATCH:
        raise ValueError(f"xc {tuple(xc.shape)}: need 1 <= B <= "
                         f"{_MAX_BATCH}, L >= 1 and d_inner >= 1")
    if xc.dtype not in _DTYPES:
        raise TypeError(f"xc is {xc.dtype}; the scan takes float32 or "
                        f"bfloat16")
    if not xc.is_contiguous():
        raise ValueError("xc must be contiguous")
    for name, t in (("dt", dt), ("b", b), ("c", c), ("a", a), ("d", d)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}, need float32")
        if t.device != xc.device:
            raise ValueError(f"xc on {xc.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def selective_scan(xc: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from h = 0 over the whole sequence.

    Args:
      xc: (B, L, d_inner) the conv output, float32 or bfloat16.
      dt: (B, L, d_inner) float32, after the softplus.
      b, c: (B, L, d_state) float32, d_state <= ``SCAN_MAX_STATE``.
      a: (d_inner, d_state) float32, A = -exp(a_log).
      d: (d_inner,) float32, the skip D.
      All contiguous, on one device.
    Returns:
      (y f32 (B, L, d_inner) = h . C + D x, h f32 (B, d_inner, d_state) at
      the last token); on a CUDA device from one launch, with no host read.
    """
    _check(xc, dt, b, c, a, d)
    if xc.device.type == "cpu":
        return selective_scan_ref(xc, dt, b, c, a, d)
    if not xc.is_cuda:
        raise ValueError(f"unsupported device {xc.device}")
    bsz, length, di = xc.shape
    st = a.shape[1]
    with spans.span(SPAN):
        y = torch.empty((bsz, length, di), dtype=torch.float32,
                        device=xc.device)
        h = torch.empty((bsz, di, st), dtype=torch.float32, device=xc.device)
        lib = _lib()
        with torch.cuda.device(xc.device):
            stream = torch.cuda.current_stream(xc.device).cuda_stream
            err = lib.selective_scan(
                xc.data_ptr(), _DTYPES[xc.dtype], dt.data_ptr(),
                b.data_ptr(), c.data_ptr(), a.data_ptr(), d.data_ptr(), bsz,
                length, di, st, y.data_ptr(), h.data_ptr(), stream)
        _build.check(lib, err, "selective_scan")
        selective_scan.launches += 1
        spans.count("selective_scan.launches")
    return y, h


selective_scan.launches = 0
