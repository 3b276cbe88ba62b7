"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import) when
no CUDA device is present.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which that machine lacks.)
"""

import pytest
import torch

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


def test_cuda_wrappers_refuse_bad_inputs(gen):
    x = torch.randn(64, 2, generator=gen).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        dops.assign_clusters(x.T.contiguous().T, x[:3].contiguous())
    with pytest.raises(ValueError, match="but c on cpu"):
        dops.assign_clusters(x, x[:3].cpu())
    with pytest.raises(ValueError):
        nops.expand_frontier(x, torch.zeros(64, dtype=torch.bool), 1.0)
