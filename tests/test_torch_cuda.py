"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import) when
no CUDA device is present.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

(``-k flash`` for the attention kernels alone.)

(``--noconftest``: tests/conftest.py imports jax, which that machine lacks.)
"""

import pytest
import torch

from repro_torch.kernels.attention import ops as aops
from repro_torch.kernels.attention.ref import attention_ref, block_error
from repro_torch.kernels.distance import fused as fops
from repro_torch.kernels.distance import ops as dops, ref as dref
from repro_torch.kernels.neighbor import ops as nops, ref as nref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (1000, 6, 2), (513, 3, 2),
                                   (256, 130, 2), (64, 5, 300), (4097, 33, 9)])
def test_assign_kernel_is_bit_exact(gen, n, k, d):
    x = (torch.randn(n, d, generator=gen) * 5).cuda()
    c = (torch.randn(k, d, generator=gen) * 5).cuda()
    before = dops.assign_clusters.launches
    idx, dist = dops.assign_clusters(x, c)
    ridx, rdist = dref.assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    assert dops.assign_clusters.launches == before + 1
    assert torch.equal(idx, ridx) and torch.equal(dist, rdist)


def test_assign_kernel_ties_and_bf16(gen):
    x = (torch.randn(500, 4, generator=gen) * 3).cuda()
    c = (torch.randn(5, 4, generator=gen) * 3).cuda()
    idx, _ = dops.assign_clusters(x, torch.cat([c, c]))
    assert int(idx.max()) < 5
    xb, cb = x.bfloat16(), c.bfloat16()
    idx, dist = dops.assign_clusters(xb, cb)
    ridx, rdist = dref.assign_clusters_ref(xb.float(), cb.float())
    assert torch.equal(idx, ridx) and torch.equal(dist, rdist)


@pytest.mark.parametrize("n,d,eps", [(256, 1, 1.0), (600, 2, 1.4142135),
                                     (1025, 4, 2.0), (129, 2, 0.5),
                                     (3000, 9, 3.0)])
def test_neighbor_kernels_are_exact(gen, n, d, eps):
    x = (torch.randn(n, d, generator=gen) * 3).cuda()
    assert torch.equal(nops.epsilon_degree(x, eps),
                       nref.epsilon_degree_ref(x, eps))
    for p in (0.0, 0.05, 1.0):
        f = (torch.rand(n, generator=gen) < p).cuda()
        assert torch.equal(nops.expand_frontier(x, f, eps),
                           nref.expand_frontier_ref(x, f, eps))


@pytest.mark.parametrize("n,k,d,n_real", [
    (1, 1, 1, 1),          # one point
    (1000, 6, 2, 1000),    # none masked
    (513, 40, 3, 400),     # k > one centroid tile, n not a tile multiple
    (300, 70, 300, 250),   # d = 300: the sums take two centroid ranges
    (777, 9, 5, 0),        # all masked
    (40000, 1024, 32, 30000),  # k > rows per block, several blocks per SM
])
def test_fused_kernel_matches_twin(gen, n, k, d, n_real):
    x = (torch.randn(n, d, generator=gen) * 4).cuda()
    c = (torch.randn(k, d, generator=gen) * 4).cuda()
    mask = (torch.arange(n) < n_real).cuda()
    before = fops.fused_masked_assign_update.launches
    idx, sums, counts, inertia = fops.fused_masked_assign_update(x, c, mask)
    ridx, rsums, rcounts, rinert = dref.fused_masked_assign_update_ref(
        x, c, mask)
    aidx, _ = dops.assign_clusters(x, c)
    torch.cuda.synchronize()
    assert fops.fused_masked_assign_update.launches == before + 1
    assert torch.equal(idx, ridx) and torch.equal(idx, aidx)
    assert torch.equal(counts, rcounts)
    assert int(counts.sum()) == n_real
    assert torch.allclose(sums, rsums, rtol=1e-5, atol=1e-5)
    assert torch.allclose(inertia, rinert, rtol=1e-5, atol=1e-5)
    # no float atomics: a second launch gives the same bits
    again = fops.fused_masked_assign_update(x, c, mask)
    for a, b in zip((idx, sums, counts, inertia), again):
        assert torch.equal(a, b)


def test_cuda_wrappers_refuse_bad_inputs(gen):
    x = torch.randn(64, 2, generator=gen).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        dops.assign_clusters(x.T.contiguous().T, x[:3].contiguous())
    with pytest.raises(ValueError, match="but c on cpu"):
        dops.assign_clusters(x, x[:3].cpu())
    with pytest.raises(ValueError):
        nops.expand_frontier(x, torch.zeros(64, dtype=torch.bool), 1.0)
    with pytest.raises(ValueError, match="mask must be bool"):
        fops.fused_masked_assign_update(x, x[:3].contiguous(),
                                        torch.ones(64, device="cuda"))
    with pytest.raises(TypeError, match="float32"):
        fops.fused_masked_assign_update(
            x.double(), x[:3].double().contiguous(),
            torch.ones(64, dtype=torch.bool, device="cuda"))


# flash attention: the reference's tolerances (tests/test_parallel.py)
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("b,s,sk,h,kv,d", [
    (1, 1, 1, 1, 1, 8),          # one query, one key
    (1, 64, 64, 2, 2, 32),       # the reference's flash-test shapes
    (2, 100, 100, 4, 2, 16),
    (1, 33, 33, 2, 1, 8),
    (1, 128, 128, 8, 2, 64),
    (2, 300, 300, 8, 8, 64),     # narrow head, ragged tiles
    (1, 517, 517, 12, 12, 96),   # d = 96: three 32-dim chunks
    (2, 70, 70, 4, 4, 12),       # d not a multiple of 4 (phi3 smoke)
    (1, 40, 90, 4, 2, 128),      # more keys than queries
    (1, 90, 40, 4, 2, 128),      # more queries than keys
    (1, 48, 48, 2, 1, 256),      # the widest head (dynamic shared memory)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(gen, b, s, sk, h, kv, d, dtype, causal):
    q = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(b, sk, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(b, sk, kv, d, generator=gen).to("cuda", dtype)
    before = aops.flash_attention.launches
    out = aops.flash_attention(q, k, v, causal=causal)
    ref = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert aops.flash_attention.launches == before + 1
    assert out.shape == (b, s, h, d) and out.dtype == dtype
    tol = ATTN_TOL[dtype]
    assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(aops.flash_attention(q, k, v, causal=causal), out)


def test_flash_kernel_reads_strided_views(gen):
    qkv = torch.randn(2, 200, 12, 64, generator=gen).cuda()  # (B, S, 3H, D)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    out = aops.flash_attention(q, k, v)
    ref = aops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="unit stride"):
        aops.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3),
                             k, v)


# The tensor-core route (csrc/flash_sm90.cu): bf16, D 64 or 128, TMA-aligned.
# It rounds the probabilities to bf16 before P.V; the bf16 tolerance is the
# reference's own, as above.  At long rows outputs are ~0.03, below that
# tolerance, so each 128-row query block of a head is also held to 1e-2 of
# its norm against the plain version in fp32 (ref.block_error).
ATTN_BLOCK_TOL_BF16 = 1e-2


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)


def _check_tc(q, k, v, causal):
    assert aops._route(q, k, v) == "tc"
    before = dict(aops.flash_attention.launches_by_route)
    out = aops.flash_attention(q, k, v, causal=causal)
    ref32 = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    ref = ref32.to(torch.bfloat16)    # what attention_ref(q, k, v) gives
    torch.cuda.synchronize()
    after = aops.flash_attention.launches_by_route
    assert after["tc"] == before["tc"] + 1
    assert after["simt"] == before["simt"]
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    tol = ATTN_TOL[torch.bfloat16]
    assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol), \
        float((out.float() - ref.float()).abs().max())
    blk = block_error(out, ref32)
    assert blk <= ATTN_BLOCK_TOL_BF16, f"block error {blk}"
    return out


@pytest.mark.parametrize("s", [1, 127, 128, 129, 1000, 4096])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_matches_plain(gen, s, d, causal):
    b, h, kv = (1, 2, 2) if s == 4096 else (2, 4, 2)
    q = _bf16(gen, b, s, h, d)
    k, v = _bf16(gen, b, s, kv, d), _bf16(gen, b, s, kv, d)
    out = _check_tc(q, k, v, causal)
    # no atomics, sums in a fixed order: a second launch gives the same bits
    assert torch.equal(aops.flash_attention(q, k, v, causal=causal), out)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_gqa_32_on_2(gen, causal):
    q = _bf16(gen, 1, 600, 32, 128)
    k, v = _bf16(gen, 1, 600, 2, 128), _bf16(gen, 1, 600, 2, 128)
    _check_tc(q, k, v, causal)


@pytest.mark.parametrize("sq,sk", [(300, 130), (130, 300), (1, 257),
                                   (257, 1)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_unequal_lengths(gen, sq, sk, d, causal):
    q = _bf16(gen, 2, sq, 4, d)
    k, v = _bf16(gen, 2, sk, 2, d), _bf16(gen, 2, sk, 2, d)
    _check_tc(q, k, v, causal)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_tc_route_reads_strided_views(gen, d):
    qkv = _bf16(gen, 2, 333, 12, d)               # (B, S, 3H, D)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    out = _check_tc(q, k, v, True)
    ref = aops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, ref)
    # heads outside sequence: (B, H, S, D) storage seen as (B, S, H, D)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert torch.equal(_check_tc(qt, kt, vt, True), ref)


def test_flash_tc_route_leaves_unaligned_views_to_simt(gen):
    flat = _bf16(gen, 1 + 2 * 100 * 4 * 64)
    q = flat[1:].view(2, 100, 4, 64)              # base 2 bytes off 16
    k, v = _bf16(gen, 2, 100, 4, 64), _bf16(gen, 2, 100, 4, 64)
    assert aops._route(q, k, v) == "simt"
    before = dict(aops.flash_attention.launches_by_route)
    out = aops.flash_attention(q, k, v)
    assert aops.flash_attention.launches_by_route["simt"] == \
        before["simt"] + 1
    ref = aops.flash_attention(q.clone(), k, v)   # aligned copy: "tc"
    assert aops.flash_attention.launches_by_route["tc"] == before["tc"] + 1
    tol = ATTN_TOL[torch.bfloat16]
    assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
