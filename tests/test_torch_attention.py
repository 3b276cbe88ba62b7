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
from repro_torch.kernels.attention.ref import attention_ref

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
