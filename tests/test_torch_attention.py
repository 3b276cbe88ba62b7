"""Port parity: the flash-attention wrapper against the reference's Pallas
kernel (interpret mode on the CPU) and its oracle.  The port's wrapper takes
its plain version for CPU tensors; on the card the same plain version is
held against the CUDA kernel by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.  Tolerances are the reference's own
(tests/test_parallel.py): 2e-4 for float32, 3e-2 for bfloat16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as jax_flash
from repro.kernels.attention.ref import attention_ref as jax_ref
from repro_torch.kernels.attention import ops as tops
from repro_torch.kernels.attention.ref import attention_ref, block_error

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# the reference's flash-kernel shapes (tests/test_parallel.py)
SHAPES = [(1, 64, 2, 2, 32), (2, 100, 4, 2, 16), (1, 33, 2, 1, 8),
          (1, 128, 8, 2, 64)]


def _qkv(b, s, h, kv, d, seed, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk or s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk or s, kv, d)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    """The same values in each framework, rounded to ``dtype`` alike."""
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("b,s,h,kv,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(b, s, h, kv, d, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, h, kv, d, seed=s * h + d),
                                       dtype)
    before = tops.flash_attention.launches
    out = tops.flash_attention(tq, tk, tv, causal=causal)
    assert tops.flash_attention.launches == before   # CPU: no kernel launch
    assert out.shape == (b, s, h, d) and out.dtype == tq.dtype
    kernel = jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                       interpret=True)
    oracle = jax_ref(jq, jk, jv, causal=causal)
    tol = TOL[dtype]
    for ref in (kernel, oracle):
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("offset", [0, 5, 40])
def test_attention_ref_causal_offset_matches_reference(offset):
    """Queries that continue a longer key sequence (the chunked prefill's
    case): query i sits at position offset + i."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 8, 4, 2, 16, seed=offset,
                                            sk=48), "float32")
    np.testing.assert_allclose(
        _f32(attention_ref(tq, tk, tv, causal_offset=offset)),
        _f32(jax_ref(jq, jk, jv, causal_offset=offset)), rtol=2e-4, atol=2e-4)


def test_flash_attention_takes_strided_inputs():
    """A (B, S, H, D) view of a larger tensor: the result is the same as on
    a contiguous copy (the kernel reads through strides, with no copy)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 20, 4, 4, 16, seed=1))
    qkv = torch.cat([q, k, v], dim=2)          # (B, S, 3H, D)
    qs, ks, vs = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    assert not qs.is_contiguous()
    assert torch.equal(tops.flash_attention(qs, ks, vs),
                       tops.flash_attention(q, k, v))


@pytest.mark.parametrize("args,error", [
    (((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16)), ValueError),   # 4 % 3
    (((1, 8, 4, 16), (1, 8, 4, 8), (1, 8, 4, 8)), ValueError),     # D differs
    (((1, 8, 4, 16), (2, 8, 4, 16), (2, 8, 4, 16)), ValueError),   # batch
    (((1, 8, 4, 16), (1, 8, 4, 16), (1, 9, 4, 16)), ValueError),   # k vs v
    (((1, 8, 4, 300), (1, 8, 4, 300), (1, 8, 4, 300)), ValueError),  # D > 256
    (((1, 8, 4, 16), (1, 0, 4, 16), (1, 0, 4, 16)), ValueError),   # no keys
    (((8, 4, 16), (8, 4, 16), (8, 4, 16)), ValueError),            # rank 3
])
def test_flash_attention_rejects_bad_shapes(args, error):
    q, k, v = (torch.zeros(s) for s in args)
    with pytest.raises(error):
        tops.flash_attention(q, k, v)


def test_flash_attention_rejects_other_dtypes():
    q = torch.zeros((1, 4, 2, 8), dtype=torch.float16)
    with pytest.raises(TypeError):
        tops.flash_attention(q, q, q)
    f = torch.zeros((1, 4, 2, 8))
    with pytest.raises(TypeError):
        tops.flash_attention(f, f.bfloat16(), f.bfloat16())


# Which kernel takes a CUDA call (kernels/attention/ops.py:_route): the
# rule reads dtype, shape, strides and base addresses only, so it is tested
# here on CPU tensors.  "tc" is the tensor-core kernel (csrc/flash_sm90.cu),
# "simt" the CUDA-core one (csrc/attention.cu).


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 8, "simt"),      # the smoke configs' narrow heads
    (torch.bfloat16, 12, "simt"),
    (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 96, "tc"),       # phi3-mini: three 64-byte boxes a row
    (torch.bfloat16, 256, "simt"),
    (torch.float32, 64, "simt"),      # fp32 keeps fp32 arithmetic
    (torch.float32, 128, "simt"),
    (torch.bfloat16, 80, "simt"),     # 160-byte rows: no whole boxes
    (torch.bfloat16, 192, "simt"),
])
def test_route_by_dtype_and_head_width(dtype, d, route):
    q = torch.zeros((2, 10, 4, d), dtype=dtype)
    k = torch.zeros((2, 10, 2, d), dtype=dtype)
    assert tops._route(q, k, k.clone()) == route


def _view(kind: str, d: int = 64) -> torch.Tensor:
    """A bf16 (2, 10, 4, d) q laid out as ``kind`` says."""
    bf = torch.bfloat16
    if kind == "contiguous":
        return torch.zeros((2, 10, 4, d), dtype=bf)
    if kind == "qkv slice":               # (B, S, 3H, D) cut along heads
        return torch.zeros((2, 10, 12, d), dtype=bf)[:, :, 4:8]
    if kind == "heads outside sequence":  # (B, H, S, D) storage
        return torch.zeros((2, 4, 10, d), dtype=bf).transpose(1, 2)
    if kind == "D not unit stride":
        return torch.zeros((2, d, 4, 10), dtype=bf).transpose(1, 3)
    if kind == "base 2 bytes off 16":
        return torch.zeros(1 + 2 * 10 * 4 * d, dtype=bf)[1:].view(2, 10, 4,
                                                                 d)
    if kind == "row stride not a multiple of 8":
        return torch.zeros((2, 10, 4 * d + 4), dtype=bf)[:, :, :4 * d] \
            .unflatten(2, (4, d))
    if kind == "size-1 dims with odd strides":   # B = H = 1: never stepped
        return torch.zeros(4096, dtype=bf).as_strided((1, 10, 1, d),
                                                      (3, d, 5, 1))
    raise ValueError(kind)


_LAYOUTS = [
    ("contiguous", "tc"),
    ("qkv slice", "tc"),
    ("heads outside sequence", "tc"),
    ("D not unit stride", "simt"),
    ("base 2 bytes off 16", "simt"),
    ("row stride not a multiple of 8", "simt"),
    ("size-1 dims with odd strides", "tc"),
]


@pytest.mark.parametrize("kind,route,d", [
    *[pytest.param(kind, route, 64, id=f"{kind}-{route}")
      for kind, route in _LAYOUTS],
    # phi3-mini's head width takes the same rules
    *[pytest.param(kind, route, 96, id=f"{kind}-{route}-d96")
      for kind, route in _LAYOUTS],
])
@pytest.mark.parametrize("which", ["q", "v"])
def test_route_by_strides_and_alignment(kind, route, d, which):
    x = _view(kind, d)
    other = torch.zeros(x.shape, dtype=x.dtype)
    q, v = (x, other) if which == "q" else (other, x)
    assert tops._route(q, other.clone(), v) == route


def test_tma_strides_fill_in_size_one_dims():
    x = _view("size-1 dims with odd strides")
    assert tops._tma_strides(x) == [64 * 10, 64, 64]
    assert tops._tma_strides(_view("qkv slice")) == [10 * 12 * 64, 12 * 64,
                                                     64]


# ref.block_error, the per-query-block check the card tests and the smoke
# add to the elementwise bf16 tolerance: at long rows outputs are ~0.03, so
# 3e-2 elementwise lets through a fault confined to a few rows.


@pytest.mark.parametrize("s,block_rows", [(1000, slice(896, 1000)),
                                          (4096, slice(3968, 4096))])
def test_block_error_catches_what_the_elementwise_bound_passes(s,
                                                               block_rows):
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, s, 2, 1, 64, seed=4))
    ref32 = attention_ref(q.float(), k.float(), v.float())
    ref = ref32.bfloat16()
    # rounding to bf16 alone: about 2e-3 of each block's norm
    assert 0 < block_error(ref, ref32) < 1e-2
    # a 5% fault in the last query block of one head
    bad = ref32.clone()
    bad[:, block_rows, 1] *= 1.05
    tol = TOL["bfloat16"]
    assert torch.allclose(bad, ref32, rtol=tol, atol=tol)
    assert block_error(bad, ref32) > 1e-2
