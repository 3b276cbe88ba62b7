"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import) when
no CUDA device is present.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which that machine lacks.)
"""

import pytest
import torch

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
