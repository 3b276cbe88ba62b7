"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import) when
no CUDA device is present.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

(``-k flash`` for the attention kernels alone, ``-k neighbor`` for the
DBSCAN ones, ``-k "moe or mamba or families"`` for the MoE FFN, the Mamba
mixer and the six archs that use them, card against host.)

(``-k wide`` for the K-Means kernels' wide search, d > 96; ``-k lloyd``
for the one-job step's narrow-row sums.)

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


# The neighbour kernels: the (n, d, eps) cases they had, then n = 1, 127,
# 2048 and the one-job path's 65536 at every width class (one box: d <= 9;
# streamed boxes: 64, 226, the widest the CUDA-core kernel took).
NEIGHBOR_CASES = ([(256, 1, 1.0), (600, 2, 1.4142135), (1025, 4, 2.0),
                   (129, 2, 0.5), (3000, 9, 3.0)]
                  + [(n, d, float(d) ** 0.5) for n in (1, 127, 2048, 65536)
                     for d in (1, 4, 8, 9, 64, 226)])


def _neighbor_check(x, eps, gen, fronts=(0.0, 0.05, 1.0)):
    """Degree and expansion equal to the plain versions, two launches
    bitwise equal, one launch counted per call; the frontier empty, one
    point, and at each fraction of ``fronts``."""
    n = x.shape[0]
    deg_before = nops.epsilon_degree.launches
    deg = nops.epsilon_degree(x, eps)
    again = nops.epsilon_degree(x, eps)
    assert nops.epsilon_degree.launches == deg_before + 2
    rdeg = nref.epsilon_degree_ref(x, eps)
    torch.cuda.synchronize()
    assert torch.equal(deg, rdeg) and torch.equal(deg, again)
    one = torch.zeros(n, dtype=torch.bool)
    one[int(torch.randint(n, (1,), generator=gen))] = True
    frontiers = [one] + [torch.rand(n, generator=gen) < p for p in fronts]
    for f in frontiers:
        f = f.cuda()
        before = nops.expand_frontier.launches
        reach = nops.expand_frontier(x, f, eps)
        again = nops.expand_frontier(x, f, eps)
        assert nops.expand_frontier.launches == before + 2
        assert torch.equal(reach, nref.expand_frontier_ref(x, f, eps))
        assert torch.equal(reach, again)


@pytest.mark.parametrize("n,d,eps", NEIGHBOR_CASES)
def test_neighbor_kernels_are_exact(gen, n, d, eps):
    x = (torch.randn(n, d, generator=gen) * 3).cuda()
    _neighbor_check(x, eps, gen)


@pytest.mark.parametrize("d", [1, 4, 9, 64, 226])
def test_neighbor_kernels_special_inputs(gen, d):
    # non-finite rows (degree 0, reach nothing), far-diagonal pads as the
    # service writes them, exact duplicates at eps = 0, pairs at eps and
    # one ulp either side, a row whose norm overflows fp32
    eps = float(d) ** 0.5
    x = torch.randn(900, d, generator=gen) * 3
    x[5, d // 2] = float("inf")
    x[9, 0] = float("nan")
    x[11, -1] = -float("inf")
    x[13] = 1e30
    pads = torch.zeros(300, d)
    pads[:, 0] = float(x[20:].max()) + 16 * eps * (1 + torch.arange(300))
    dup = x[20:60].clone()
    base = x[100:101]
    e = float(torch.tensor(float(((x[100] - x[101]) ** 2).sum())).sqrt())
    near = torch.cat([x[101:102], torch.nextafter(x[101:102], base + 1e3),
                      torch.nextafter(x[101:102], base - 1e3)])
    x = torch.cat([x, pads, dup, near]).contiguous().cuda()
    for eps_ in (eps, 0.0, e):
        _neighbor_check(x, eps_, gen, fronts=(0.05,))
    deg = nops.epsilon_degree(x, eps)
    assert int(deg[5]) == 0 and int(deg[9]) == 0 and int(deg[11]) == 0
    assert bool((deg[900:1200] == 1).all())


def _cross_check(x, eps, gen, splits):
    """The cross entries over row and column shards of x (bounds in
    ``splits``): each call equal to its plain twin, the counts summed over
    the column shards equal to epsilon_degree_ref and the flags OR-ed equal
    to expand_frontier_ref, bit for bit; one launch counted per call."""
    n = x.shape[0]
    front = (torch.rand(n, generator=gen) < 0.05).cuda()
    cuts = list(zip(splits[:-1], splits[1:]))
    deg = torch.zeros(n, dtype=torch.int32, device="cuda")
    reach = torch.zeros(n, dtype=torch.bool, device="cuda")
    for r0, r1 in cuts:
        for c0, c1 in cuts:
            rows, cols, f = x[r0:r1], x[c0:c1], front[c0:c1]
            before = (nops.epsilon_degree_cross.launches,
                      nops.expand_frontier_cross.launches)
            dc = nops.epsilon_degree_cross(rows, cols, eps)
            rc = nops.expand_frontier_cross(rows, cols, f, eps)
            assert (nops.epsilon_degree_cross.launches,
                    nops.expand_frontier_cross.launches) == (
                        before[0] + 1, before[1] + 1)
            assert torch.equal(dc, nref.epsilon_degree_cross_ref(
                rows, cols, eps))
            assert torch.equal(rc, nref.expand_frontier_cross_ref(
                rows, cols, f, eps))
            deg[r0:r1] += dc
            reach[r0:r1] |= rc
    torch.cuda.synchronize()
    assert torch.equal(deg, nref.epsilon_degree_ref(x, eps))
    assert torch.equal(reach, nref.expand_frontier_ref(x, front, eps))


@pytest.mark.parametrize("d", [1, 4, 9, 64])
def test_neighbor_cross_entries_sum_to_the_whole(gen, d):
    # shards of 1, 63, 64, 65 and uneven larger ones, the diagonal included
    n = 3000
    x = (torch.randn(n, d, generator=gen) * 3).contiguous().cuda()
    _cross_check(x, float(d) ** 0.5, gen,
                 [0, 1, 64, 127, 192, 1000, 2311, n])


@pytest.mark.parametrize("d", [1, 4, 9, 64])
def test_neighbor_cross_entries_near_ties_and_pads(gen, d):
    # pairs at eps and one ulp either side, exact duplicates at eps = 0,
    # non-finite rows, and a far-diagonal ladder of pads as the
    # distributed lane writes them (the pads about a quarter of the rows,
    # as a 100,000-point request padded to 131,072)
    eps = float(d) ** 0.5
    x = torch.randn(1500, d, generator=gen) * 3
    x[7, 0] = float("nan")
    x[8, -1] = float("inf")
    base = x[100:101]
    e = float(torch.tensor(float(((x[100] - x[101]) ** 2).sum())).sqrt())
    near = torch.cat([x[101:102], torch.nextafter(x[101:102], base + 1e3),
                      torch.nextafter(x[101:102], base - 1e3)])
    pads = torch.zeros(500, d)
    pads[:, 0] = float(x[10:].max()) + 16 * eps * (1 + torch.arange(500))
    x = torch.cat([x, x[20:60], near, pads]).contiguous().cuda()
    n = x.shape[0]
    splits = [0, n // 4, n // 2, 3 * n // 4, n]
    for eps_ in (eps, 0.0, e):
        _cross_check(x, eps_, gen, splits)


@pytest.mark.parametrize("nr,nc", [(1, 1), (64, 2048), (2048, 65), (32768,
                                                                    32768)])
def test_neighbor_cross_plan_takes_the_rectangle(gen, nr, nc):
    for expand in (False, True):
        p = nops.plan(nr, 4, expand, cols=nc)
        assert not p.triangle
        assert p.row_groups * 64 * p.groups >= nr
        assert p.slice_len % 64 == 0 and p.slices * p.slice_len >= nc
        assert (p.slices - 1) * p.slice_len < nc
        assert p.blocks == p.row_groups * p.slices
    x = (torch.randn(nr + nc, 4, generator=gen) * 3).cuda()
    nops.epsilon_degree_cross(x[:nr], x[nr:], 2.0)
    _, pairs = nops.rechecks(nops.epsilon_degree_cross)
    assert pairs == nr * nc


@pytest.mark.parametrize("n,k,d,cuts", [
    (100000, 64, 32, 4), (5000, 7, 5, 3), (3000, 70, 200, 2),
    (1048576, 64, 32, 4), (1 << 18, 4096, 128, 16), (20000, 4, 300, 3)])
def test_fused_passes_over_block_cuts_are_the_whole_step(gen, n, k, d, cuts):
    # pass 1 over cuts at the whole launch's blocks writes the whole
    # launch's partials; pass 2 over them gives its sums, bit for bit
    x = (torch.randn(n, d, generator=gen) * 4).cuda()
    c = x[torch.randperm(n, generator=gen)[:k].cuda()].contiguous()
    mask = (torch.arange(n) < n - 97).cuda()
    idx, sums, counts, inertia = fops.fused_masked_assign_update(x, c, mask)
    rows = fops.block_rows(n, k, d)
    blocks = -(-n // rows)
    cut = [min(n, rows * (i * blocks // cuts)) for i in range(cuts + 1)]
    whole_idx, whole_part = fops.fused_masked_partials(x, c, mask, rows)
    parts = [fops.fused_masked_partials(x[a:b], c, mask[a:b], rows)
             for a, b in zip(cut[:-1], cut[1:])]
    part = torch.cat([p for _, p in parts])
    assert torch.equal(part, whole_part) and part.shape[0] == blocks
    assert torch.equal(torch.cat([i for i, _ in parts]), idx)
    assert torch.equal(whole_idx, idx)
    before = fops.reduce_partials.launches
    got = fops.reduce_partials(part, k, d)
    assert fops.reduce_partials.launches == before + 1
    for a, b in zip(got, (sums, counts, inertia)):
        assert torch.equal(a, b)
    # pass 2 against its plain twin, on the same partials
    for a, b in zip(got, fops.reduce_partials_ref(part.cpu(), k, d)):
        assert torch.equal(a.cpu(), b)


def test_neighbor_unaligned_rows(gen):
    # x starts 4 bytes past a 16-byte boundary (a view into a larger
    # buffer); the frontier one byte past
    flat = (torch.randn(1 + 3000 * 3, generator=gen) * 3).cuda()
    x = flat[1:].view(3000, 3)
    fl = torch.rand(3001, generator=gen).cuda() < 0.1
    f = fl[1:]
    assert torch.equal(nops.epsilon_degree(x, 1.7),
                       nref.epsilon_degree_ref(x, 1.7))
    assert torch.equal(nops.expand_frontier(x, f, 1.7),
                       nref.expand_frontier_ref(x, f, 1.7))


@pytest.mark.parametrize("d", [1, 4, 9, 10, 64, 226])
def test_neighbor_plan_keeps_every_width(gen, d):
    # every width the CUDA-core kernel took (d <= 226) fits a block, with
    # either kernel's plan, at the one-job path's n and at a small one
    assert nops._lib().neighbor_smem_bytes(d) <= nops.MAX_SMEM
    for n in (2048, 65536):
        for expand in (False, True):
            assert nops.plan(n, d, expand).groups == (2 if d <= 9 else 1)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 2048, 16384, 65536])
def test_neighbor_plan_covers_the_points_with_enough_blocks(gen, n):
    for expand in (False, True):
        p = nops.plan(n, 4, expand)
        assert p.triangle == (not expand)
        assert p.row_groups * 64 * p.groups >= n
        if not p.triangle:
            assert p.slice_len % 64 == 0 and p.slices * p.slice_len >= n
            assert (p.slices - 1) * p.slice_len < n
        # the grid fills the card's 132 SMs wherever the columns allow
        assert p.blocks >= min(132, -(-n // 64))


def test_neighbor_scored_pairs(gen):
    x = (torch.randn(4096, 4, generator=gen) * 3).cuda()
    nops.epsilon_degree(x, 2.0)
    total, pairs = nops.rechecks(nops.epsilon_degree)
    # the triangle scores each pair once, and the band tiles (a row
    # group's own columns) in full; few pairs fall inside the window
    p = nops.plan(4096, 4)
    band = p.row_groups * (64 * p.groups) ** 2
    assert pairs == (4096 * 4096 - band) // 2 + band
    assert 0 < total < pairs // 100
    f = torch.zeros(4096, dtype=torch.bool, device="cuda")
    f[::50] = True
    nops.expand_frontier(x, f, 2.0)
    total, pairs = nops.rechecks(nops.expand_frontier)
    assert 0 < pairs <= 4096 * int(f.sum()) and total < pairs // 100


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


def _same_bits(a, b):
    """Equal bits, NaN matching NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32)))


def _near_ties(gen, d, with_non_finite=True):
    """Points at the midpoints of centroid pairs and 1 ulp either side,
    duplicate centroids, points equal to a centroid, random points, and
    (last) a row holding inf and one holding NaN."""
    c = torch.randn(24, d, generator=gen) * 3
    c = torch.cat([c, c[:6]])                     # 24..29 duplicate 0..5
    mid = (c[:12] + c[12:24]) / 2
    up = torch.nextafter(mid, torch.full_like(mid, float("inf")))
    down = torch.nextafter(mid, torch.full_like(mid, -float("inf")))
    x = torch.cat([mid, up, down, c, c[:6] + 1e-7,
                   torch.randn(300, d, generator=gen) * 3])
    if with_non_finite:
        bad = torch.randn(2, d, generator=gen)
        bad[0, d // 2] = float("inf")
        bad[1, 0] = float("nan")
        x = torch.cat([x, bad])
    return x.contiguous().cuda(), c.contiguous().cuda()


@pytest.mark.parametrize("d", [1, 5, 32, 64])
def test_assign_kernel_near_ties_are_bit_exact(gen, d):
    x, c = _near_ties(gen, d)
    for with_dists in (False, True):
        idx, out = dops.assign_clusters(x, c, with_dists=with_dists)
        ridx, rscore = dref.assign_scores_ref(x, c)
        rout = dref.add_point_norms(x, rscore) if with_dists else rscore
        torch.cuda.synchronize()
        assert torch.equal(idx, ridx)
        assert _same_bits(out, rout)
    # a centroid holding inf or NaN: every point rechecks it exactly
    cbad = c.clone()
    cbad[3, 0] = float("inf")
    cbad[7, d - 1] = float("nan")
    idx, score = dops.assign_clusters(x, cbad, with_dists=False)
    ridx, rscore = dref.assign_scores_ref(x, cbad)
    assert torch.equal(idx, ridx) and _same_bits(score, rscore)


@pytest.mark.parametrize("d", [1, 5, 32, 64])
def test_fused_kernel_near_ties_match_twin(gen, d):
    x, c = _near_ties(gen, d)
    n = x.shape[0]
    finite = torch.isfinite(x).all(1)
    mask = finite & (torch.arange(n, device="cuda") % 5 != 0)
    idx, sums, counts, inertia = fops.fused_masked_assign_update(x, c, mask)
    ridx, _, rcounts, rinert = dref.fused_masked_assign_update_ref(x, c, mask)
    aidx, _ = dops.assign_clusters(x, c)
    # the plain version's one-hot product multiplies the masked-out inf and
    # NaN rows by 0 (NaN): its sums are taken over the finite rows alone
    _, rsums, _, _ = dref.fused_masked_assign_update_ref(
        x[finite], c, mask[finite])
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(idx, aidx)
    assert torch.equal(counts, rcounts)
    assert torch.allclose(sums, rsums, rtol=1e-5, atol=1e-5)
    assert torch.allclose(inertia, rinert, rtol=1e-5, atol=1e-5)
    again = fops.fused_masked_assign_update(x, c, mask)
    for a, b in zip((idx, sums, counts, inertia), again):
        assert torch.equal(a, b)


def test_assign_kernel_unaligned_rows_take_cp_async(gen):
    # d = 32 but x starts 4 bytes past a 16-byte boundary: no TMA
    flat = (torch.randn(1 + 5000 * 32, generator=gen) * 5).cuda()
    x = flat[1:].view(5000, 32)
    c = (torch.randn(64, 32, generator=gen) * 5).cuda()
    idx, dist = dops.assign_clusters(x, c)
    ridx, rdist = dref.assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(dist, rdist)
    fidx = fops.fused_masked_assign_update(
        x, c, torch.ones(5000, dtype=torch.bool, device="cuda"))[0]
    assert torch.equal(fidx, ridx)


@pytest.mark.parametrize("d", [96, 128])
def test_fused_kernel_sums_over_several_ranges(gen, d):
    # 600 centroids of 96 features (staged rows: the centroids stream
    # chunk by chunk) or 128 (wide rows: the later ranges read back the
    # indices): the sums take several shared-memory ranges
    n, k = 3000, 600
    assert fops.launch_shape(n, k, d)[2] < k
    x = (torch.randn(n, d, generator=gen) * 4).cuda()
    c = (torch.randn(k, d, generator=gen) * 4).cuda()
    mask = (torch.arange(n) < 2500).cuda()
    idx, sums, counts, inertia = fops.fused_masked_assign_update(x, c, mask)
    ridx, rsums, rcounts, rinert = dref.fused_masked_assign_update_ref(
        x, c, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(counts, rcounts)
    assert torch.allclose(sums, rsums, rtol=1e-5, atol=1e-5)
    assert torch.allclose(inertia, rinert, rtol=1e-5, atol=1e-5)


# Wide rows (d > 96, the products streamed box by box): 16-byte copies
# (1024, 1792, 164) and 4-byte ones (1561, 1751, 1815; the last two the
# widest rows the CUDA-core kernels took in the fused step and the
# assignment), one chunk and several, the sums over several ranges.
@pytest.mark.parametrize("n,k,d", [(300, 64, 1024), (200, 70, 1561),
                                   (200, 64, 1792), (150, 1, 1751),
                                   (150, 9, 1815), (1000, 130, 164),
                                   (4100, 33, 161)])
def test_wide_rows_are_bit_exact(gen, n, k, d):
    x = (torch.randn(n, d, generator=gen) * 4).cuda()
    c = (torch.randn(k, d, generator=gen) * 4).cuda()
    c[k // 2] = c[0]                                  # a duplicate centroid
    x[:k] = c                                         # points on centroids
    idx, dist = dops.assign_clusters(x, c)
    ridx, rdist = dref.assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(dist, rdist)
    mask = (torch.arange(n) % 4 != 1).cuda()
    fidx, sums, counts, inertia = fops.fused_masked_assign_update(x, c, mask)
    _, rsums, rcounts, rinert = dref.fused_masked_assign_update_ref(x, c,
                                                                   mask)
    torch.cuda.synchronize()
    assert torch.equal(fidx, ridx) and torch.equal(counts, rcounts)
    # the kernel adds a centroid's rows in row order, the plain version by
    # a matrix product: a sum over many rows that cancels keeps only the
    # precision of the magnitudes summed
    onehot = (ridx[:, None] == torch.arange(k, device="cuda")) & mask[:, None]
    scale = onehot.float().T @ x.abs()
    assert bool(((sums - rsums).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.allclose(inertia, rinert, rtol=1e-5, atol=1e-5)


def test_wide_assignment_at_the_embedding_width(gen):
    # the embedding example's shape: 1,024 L2-normalised documents of
    # d_model = 2048 against k = 4 k-means++ centroids (the wide search),
    # with a point on each centroid and a duplicate centroid; then the
    # example's whole fit against the plain versions
    from repro_torch.core import kmeans
    from repro_torch.examples import embedding_clustering as ec

    n, d, k = 1024, 2048, 4
    x = torch.randn(n, d, generator=gen)
    x = (x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6))
    x = x.cuda()
    c = kmeans.init_centroids(0, x, kmeans.KMeansConfig(k=k,
                                                        init="kmeans++"))
    assert dops.plan(n, k, d).wide
    for cc in (c, torch.cat([c[:3], c[:1]])):
        for with_dists in (True, False):
            idx, out = dops.assign_clusters(x, cc, with_dists=with_dists)
            ridx, rscore = dref.assign_scores_ref(x, cc)
            rout = dref.add_point_norms(x, rscore) if with_dists else rscore
            torch.cuda.synchronize()
            assert torch.equal(idx, ridx) and torch.equal(out, rout)
    before = dops.assign_clusters.launches
    res = ec.cluster(x, k, seed=2)
    plain = ec.cluster(x, k, seed=2, use_kernel=False)
    assert dops.assign_clusters.launches - before == int(res.iterations)
    assert torch.equal(res.labels, plain.labels)
    assert int(res.iterations) == int(plain.iterations)


@pytest.mark.parametrize("d", [5, 32, 64])
def test_wide_search_at_narrow_rows(gen, monkeypatch, d):
    # the wide search forced onto rows of one or two boxes (fewer box
    # steps than its ring holds), with several tiles a block
    monkeypatch.setattr(dops, "WIDE_D", 0)
    n, k = 70000, 40
    x = (torch.randn(n, d, generator=gen) * 4).cuda()
    c = (torch.randn(k, d, generator=gen) * 4).cuda()
    assert dops.plan(n, k, d).wide and dops.plan(n, k, d).tiles_per_block > 1
    idx, dist = dops.assign_clusters(x, c)
    ridx, rdist = dref.assign_clusters_ref(x, c)
    mask = (torch.arange(n) % 3 != 0).cuda()
    fidx, _, counts, _ = fops.fused_masked_assign_update(x, c, mask)
    _, _, rcounts, _ = dref.fused_masked_assign_update_ref(x, c, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(dist, rdist)
    assert torch.equal(fidx, ridx) and torch.equal(counts, rcounts)


# The wide search (d > 96) at small n, against the plain versions: the
# exact form (k <= 8) and the TF32 form (k = 9: one chunk of 16; 64; 4,096:
# 64 chunks, x's tile resident where it fits), 16-byte copies or TMA (97
# takes 4-byte copies), one tile and several; then the fused step's sums,
# and a second launch bitwise equal.
WIDE_NS = [1, 17, 63, 65, 1024]
WIDE_KS = [1, 4, 9, 64, 4096]
WIDE_DS = [97, 128, 1815, 2048, 4096]


def _check_wide(x, c, mask):
    n, k = x.shape[0], c.shape[0]
    for with_dists in (True, False):
        idx, out = dops.assign_clusters(x, c, with_dists=with_dists)
        ridx, rscore = dref.assign_scores_ref(x, c)
        rout = dref.add_point_norms(x, rscore) if with_dists else rscore
        torch.cuda.synchronize()
        assert torch.equal(idx, ridx) and _same_bits(out, rout)
    got = fops.fused_masked_assign_update(x, c, mask)
    fidx, sums, counts, inertia = got
    finite = torch.isfinite(x).all(1)
    _, _, rcounts, rinert = dref.fused_masked_assign_update_ref(x, c, mask)
    _, rsums, _, _ = dref.fused_masked_assign_update_ref(
        x[finite], c, mask[finite])
    torch.cuda.synchronize()
    assert torch.equal(fidx, ridx) and torch.equal(counts, rcounts)
    onehot = (ridx[finite, None] == torch.arange(k, device="cuda")) \
        & mask[finite, None]
    scale = onehot.float().T @ x[finite].abs()
    assert bool(((sums - rsums).abs() <= 1e-5 * scale + 1e-6).all())
    assert torch.allclose(inertia, rinert, rtol=1e-5, atol=1e-5)
    again = fops.fused_masked_assign_update(x, c, mask)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", WIDE_DS)
@pytest.mark.parametrize("k", WIDE_KS)
@pytest.mark.parametrize("n", WIDE_NS)
def test_wide_search_small_n_is_bit_exact(gen, n, k, d):
    c = (torch.randn(k, d, generator=gen) * 4).cuda()
    x = (c[torch.randint(0, k, (n,), generator=gen).cuda()]
         + torch.randn(n, d, generator=gen).cuda())
    assert dops.plan(n, k, d).wide
    mask = (torch.arange(n) % 3 != 1).cuda()
    _check_wide(x.contiguous(), c, mask)


@pytest.mark.parametrize("d", [97, 128, 2048])
def test_wide_search_near_ties_are_bit_exact(gen, d):
    # midpoints of centroid pairs +-1 ulp, duplicate centroids, points on
    # centroids, an inf row and a NaN row; then centroids holding inf and
    # NaN; at k = 30 (TF32 form) and k = 5 (exact form)
    x, c = _near_ties(gen, d)
    n = x.shape[0]
    mask = torch.isfinite(x).all(1) & (torch.arange(n, device="cuda") % 5 != 0)
    for cc in (c, c[:5].contiguous()):
        _check_wide(x, cc, mask)
    cbad = c.clone()
    cbad[3, 0] = float("inf")
    cbad[7, d - 1] = float("nan")
    for cc in (cbad, cbad[:8].contiguous()):
        idx, score = dops.assign_clusters(x, cc, with_dists=False)
        ridx, rscore = dref.assign_scores_ref(x, cc)
        assert torch.equal(idx, ridx) and _same_bits(score, rscore)


def test_wide_search_pod_widths_and_rechecks(gen):
    # the pod-scale cell's widths at 2^16 points: k = 4,096 in 64 chunks,
    # x's tile resident, tiles on every SM; indices, scores and the fused
    # step's partials as the plain versions', and the deferred rechecks
    # about one a point (they were ~4.8 rechecked chunk by chunk)
    n, k, d = 1 << 16, 4096, 128
    c = (torch.randn(k, d, generator=gen) * 4).cuda()
    x = (c[torch.randint(0, k, (n,), generator=gen).cuda()]
         + torch.randn(n, d, generator=gen).cuda()).contiguous()
    p = dops.plan(n, k, d)
    sms = dops.sm_count(x.device)
    assert p.xres and dops.search_grid(p, sms) == min(sms, n // 128)
    mask = (torch.arange(n) < n - 100).cuda()
    _check_wide(x, c, mask)
    dops.assign_clusters(x, c)
    total, most = dops.rechecks(dops.assign_clusters)
    assert n <= total < 2 * n and 1 <= most <= 4096


def test_plan_bytes_match_the_library(gen):
    # ops.py plans with its own statement of the layout; the libraries own
    # it (csrc/assign_common.cuh, csrc/fused.cu)
    alib, flib = dops._lib(), fops._lib()
    for n, k, d in [(1 << 20, 64, 32), (65536, 1024, 32), (300, 70, 300),
                    (64, 5, 300), (1, 1, 1), (3000, 600, 128), (10, 3, 900),
                    (300, 64, 1024), (200, 70, 1561), (150, 1, 1751),
                    (150, 9, 1815), (100, 8, 4096), (7, 3, 9), (9, 5, 161),
                    (1024, 4, 2048), (1 << 24, 4096, 128),
                    (65536, 64, 192), (300, 4096, 320)]:
        p = dops.plan(n, k, d)
        assert alib.assign_smem_bytes(d, p.tm, p.nt, p.slots, int(p.wide),
                                      p.stages, int(p.xres)
                                      ) == dops.assign_bytes(d, p)
        assert 4 * alib.centroid_pack_floats(k, d, p.nt) == (
            -(-k // (8 * p.nt)) * dops.chunk_bytes(d, p.nt))
        fp, acc_k = fops._plan(n, k, d)
        assert flib.fused_smem_bytes(d, fp.tm, fp.nt, fp.slots,
                                     int(fp.wide), acc_k) == dops.fused_bytes(
                                         d, fp, acc_k)


def test_recheck_counts(gen):
    x = (torch.randn(4096, 32, generator=gen) * 3).cuda()
    c = (torch.randn(64, 32, generator=gen) * 3).cuda()
    dops.assign_clusters(x, c)
    total, most = dops.rechecks(dops.assign_clusters)
    # every point rechecks its winner; few need a second candidate
    assert 4096 <= total < 2 * 4096 and 1 <= most <= 64
    fops.fused_masked_assign_update(
        x, c, torch.ones(4096, dtype=torch.bool, device="cuda"))
    assert dops.rechecks(fops.fused_masked_assign_update) == (total, most)


# The one-job step's narrow-row sums (lloyd_sums_kernel): n not a multiple
# of a block, n below a warp, k = 1, d = 1, an empty cluster (centroid k - 1),
# k and d at their limits (8 and 4), the examples' shapes (quickstart's
# 6,144 points of 2 features in 6 clusters; mine_cluster's grid), and the
# benchmark's 2^24 rows of 4 features at k = 8.
LLOYD_CASES = [(1000, 8, 4), (300, 5, 3), (17, 3, 2), (5, 1, 1), (3, 4, 4),
               (4097, 1, 1), (70001, 8, 1), (70001, 8, 3), (70001, 1, 4),
               (6144, 6, 2), (2048, 4, 2), (70001, 7, 4), (1 << 24, 8, 4)]


def _lloyd_inputs(gen, n, k, d):
    x = (torch.randn(n, d, generator=gen) * 4).cuda()
    idx = torch.randint(0, k, (n,), generator=gen, dtype=torch.int32)
    if k > 1:
        idx[idx == k - 1] = 0
    return x, idx.cuda()


@pytest.mark.parametrize("n,k,d", LLOYD_CASES)
def test_lloyd_sums_kernel_is_bit_exact(gen, n, k, d):
    x, idx = _lloyd_inputs(gen, n, k, d)
    before = fops.lloyd_sums.launches
    sums, counts = fops.lloyd_sums(x, idx, k)
    blocks = fops.lloyd_blocks(n)
    rsums, rcounts = dref.lloyd_sums_ref(x, idx, k, blocks)
    torch.cuda.synchronize()
    assert fops.lloyd_sums.launches == before + 1
    assert torch.equal(sums, rsums) and torch.equal(counts, rcounts)
    # no float atomics: a second launch gives the same bits
    again = fops.lloyd_sums(x, idx, k)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)
    # within fp32 rounding of the float64 sums: m additions on the longest
    # path (a thread's rows, the xor tree, the warps, pass 2) give at most
    # m u sum |x|
    onehot = (idx[:, None].long()
              == torch.arange(k, device="cuda")).double()
    exact, scale = onehot.T @ x.double(), onehot.T @ x.double().abs()
    m = (-(-n // (blocks * dref.LLOYD_THREADS)) + 5 + 7
         + -(-blocks // dref.REDUCE_RUNS) + dref.REDUCE_RUNS - 1)
    assert torch.equal(counts.double(), onehot.sum(0))
    assert bool(((sums.double() - exact).abs()
                 <= 1.01 * m * 2.0 ** -24 * scale).all())


def test_lloyd_sums_kernel_unaligned_rows_take_scalar_loads(gen):
    # rows of 4 features 4 bytes past a 16-byte boundary: no float4 loads,
    # the same sums
    n, k, d = 5000, 8, 4
    buf = (torch.randn(n * d + 1, generator=gen) * 4).cuda()
    x = buf[1:].view(n, d)
    assert x.data_ptr() % 16 != 0
    idx = torch.randint(0, k, (n,), generator=gen, dtype=torch.int32).cuda()
    sums, counts = fops.lloyd_sums(x, idx, k)
    asums, acounts = fops.lloyd_sums(x.clone(), idx, k)
    torch.cuda.synchronize()
    assert torch.equal(sums, asums) and torch.equal(counts, acounts)


def test_lloyd_sums_kernel_keeps_a_nan_row_in_its_own_centroid(gen):
    """NaN input splits the lanes on purpose, as the fused kernel does:
    the narrow-row sums add a NaN row to its own centroid only, the plain
    version's one-hot product to every centroid.  The one-job fit of
    tests/test_torch_nan_input.py's case (the reference's labels on the
    host) ends on the same labels and iterations on both lanes, and only
    the kernel lane keeps the other centroid finite."""
    import numpy as np
    from dataclasses import replace

    from repro_torch.core import kmeans

    rng = np.random.default_rng(1)
    xn = rng.normal(size=(128, 2)).astype(np.float32)
    xn[:64] += 6.0
    xn[7, 0] = np.nan
    x = torch.from_numpy(xn).cuda()
    idx = torch.zeros(128, dtype=torch.int32, device="cuda")
    idx[64:] = 1
    sums, counts = fops.lloyd_sums(x, idx, 2)
    rsums, rcounts = dref.lloyd_sums_ref(x, idx, 2, fops.lloyd_blocks(128))
    psums, pcounts = kmeans._weighted_sums(x, idx, 2)
    torch.cuda.synchronize()
    assert torch.equal(counts, rcounts) and torch.equal(counts, pcounts)
    assert torch.isnan(sums[0, 0]) and torch.isnan(rsums[0, 0])
    assert torch.equal(sums[0, 1:], rsums[0, 1:])
    assert torch.equal(sums[1], rsums[1]) and torch.isfinite(sums[1]).all()
    assert torch.isnan(psums[:, 0]).all()

    cfg = kmeans.KMeansConfig(k=2, max_iters=20)
    c0 = x[[0, 100]].clone()
    before = fops.lloyd_sums.launches
    res = kmeans.fit_cancellable(None, x, cfg, centroids=c0)
    plain = kmeans.fit_cancellable(None, x, replace(cfg, use_kernel=False),
                                   centroids=c0)
    assert fops.lloyd_sums.launches - before == int(res.iterations) == 20
    assert torch.equal(res.labels, plain.labels)
    assert int(res.iterations) == int(plain.iterations)
    assert (res.labels == 0).all() and not bool(res.converged)
    assert torch.isnan(res.centroids[0, 0])
    assert torch.isfinite(res.centroids[1]).all()
    assert torch.isnan(plain.centroids[:, 0]).all()


def test_lloyd_sums_kernel_takes_the_narrow_fit(gen):
    # fit_cancellable at a narrow shape launches the sums once a step and
    # the search as before; the plain config launches neither, and keeps
    # the product
    from dataclasses import replace

    from repro_torch.core import kmeans
    from repro_torch.data import synthetic as synth

    x, _, _ = synth.make_blobs(5, synth.ClusterSpec(4, 8, 4096),
                               device="cuda")
    cfg = kmeans.KMeansConfig(k=8, max_iters=50)
    c0 = kmeans.init_centroids(5, x, cfg)
    sums0, assign0 = fops.lloyd_sums.launches, dops.assign_clusters.launches
    res = kmeans.fit_cancellable(5, x, cfg, centroids=c0)
    iters = int(res.iterations)
    assert iters >= 2
    assert fops.lloyd_sums.launches - sums0 == iters
    assert dops.assign_clusters.launches - assign0 == iters
    sums1, assign1 = fops.lloyd_sums.launches, dops.assign_clusters.launches
    plain = kmeans.fit_cancellable(5, x, replace(cfg, use_kernel=False),
                                   centroids=c0)
    assert fops.lloyd_sums.launches == sums1
    assert dops.assign_clusters.launches == assign1
    assert torch.equal(res.labels, plain.labels)
    assert int(res.iterations) == int(plain.iterations)
    # the mini-batch step takes the same rule
    state = kmeans.minibatch_init(5, x[:1024], cfg)
    kmeans.minibatch_step(state, x[:1024], cfg)
    assert fops.lloyd_sums.launches == sums1 + 1


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


def test_flash_wrapper_raises_on_inputs_that_need_a_gradient(gen):
    """The kernels have no backward: a result autograd cannot see through
    would leave wq, wk and wv without gradients, so the wrapper refuses."""
    q = torch.randn(1, 64, 2, 64, generator=gen).cuda().requires_grad_()
    k = torch.randn(1, 64, 2, 64, generator=gen).cuda()
    before = aops.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        aops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        aops.flash_attention(k, q, k)
    assert aops.flash_attention.launches == before
    with torch.no_grad():
        out = aops.flash_attention(q, k, k)
    assert aops.flash_attention.launches == before + 1
    assert not out.requires_grad
    out2 = aops.flash_attention(q.detach(), k, k)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


# the dense archs (minicpm's padded heads and tied embeddings, glm4's GQA,
# phi3-mini), and the six archs of the MoE, Mamba, hybrid and
# stub-frontend families; (arch, top_k) with olmoe's smoke config also at
# top-8, olmoe-1b-7b's published k
TRAIN_ARCHS = ["minicpm-2b", "internvl2-26b", "musicgen-medium",
               "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b",
               "jamba-v0.1-52b", "glm4-9b", "phi3-mini-3.8b"]
TRAIN_CASES = [(arch, None) for arch in TRAIN_ARCHS] + [("olmoe-1b-7b", 8)]
TRAIN_IDS = TRAIN_ARCHS + ["olmoe-1b-7b-top8"]


def _train_setup(arch, top_k=None, **change):
    """A smoke config (chunked CE and attention), its params on the host
    and a batch with a stub frontend's prefix embeddings."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime import backend
    from repro_torch.train import step as tstep

    backend.load("cuda")  # fp32 matmul at "highest"
    if top_k is not None:
        change["top_k"] = top_k
    cfg = dataclasses.replace(get_smoke_config(arch), loss_chunk=2,
                              attn_chunk=16, **change)
    host = tstep.init_train_state(0, cfg, device="cpu")
    batch = tstep.make_train_batch(torch.Generator().manual_seed(1), cfg,
                                   4, 32)
    return cfg, host.params, batch


def _recorded_routing(monkeypatch, calls):
    """Every MoE call of the model also records its router ids and keep
    mask (``moe.routing`` on the same input, outside autograd)."""
    from repro_torch.models import lm, moe

    saved = moe.moe_ffn

    def recorded(params, x, cfg, *, no_drop=False):
        with torch.no_grad():
            calls.append(moe.routing(params, x, cfg, no_drop=no_drop))
        return saved(params, x, cfg, no_drop=no_drop)

    monkeypatch.setattr(lm, "moe_ffn", recorded)


@pytest.mark.parametrize("arch,top_k", TRAIN_CASES, ids=TRAIN_IDS)
def test_training_gradients_on_the_card_match_the_host(arch, top_k,
                                                       monkeypatch):
    """A smoke-config training loss and its gradients on the card (fp32)
    against the same on the host, through the training attention route:
    the flash counter stays put; every MoE call routes alike first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.train import step as tstep
    from repro_torch.tree import tree_leaves, tree_map

    cfg, host, batch = _train_setup(arch, top_k)
    card = tstep.as_trainable(tree_map(lambda p: p.detach().cuda(), host))
    before = aops.flash_attention.launches
    calls_h, calls_c = [], []
    _recorded_routing(monkeypatch, calls_h)
    loss_h, _, g_h = tstep.loss_and_grads(host, batch, cfg)
    _recorded_routing(monkeypatch, calls_c)
    loss_c, _, g_c = tstep.loss_and_grads(
        card, {k: v.cuda() for k, v in batch.items()}, cfg)
    torch.cuda.synchronize()
    assert aops.flash_attention.launches == before
    n_moe = cfg.n_groups * sum(ff == "moe" for _m, ff in cfg.pattern)
    assert len(calls_c) == len(calls_h) >= n_moe   # + remat recomputes
    for (ids_c, keep_c), (ids_h, keep_h) in zip(calls_c, calls_h):
        assert torch.equal(ids_c.cpu(), ids_h)
        assert torch.equal(keep_c.cpu(), keep_h)
    assert abs(float(loss_c) - float(loss_h)) <= 1e-5 * abs(float(loss_h))
    for a, b in zip(tree_leaves(g_c), tree_leaves(g_h)):
        scale = float(b.abs().max())
        assert scale > 0 and torch.isfinite(a).all()
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,top_k", TRAIN_CASES, ids=TRAIN_IDS)
def test_training_step_two_runs_on_the_card_are_bitwise_equal(arch, top_k,
                                                              dtype):
    """The loss and every gradient leaf of one step, twice from the same
    params and batch on the card: bit for bit (the MoE backward adds a
    token's k slot gradients in ascending expert id, no float atomics);
    capacity 0.5 so the MoE archs drop choices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.train import step as tstep
    from repro_torch.tree import tree_leaves, tree_map

    cfg, host, batch = _train_setup(arch, top_k, dtype=dtype,
                                    capacity_factor=0.5)
    card = tstep.as_trainable(tree_map(lambda p: p.detach().cuda(), host))
    batch = {k: v.cuda() for k, v in batch.items()}
    runs = [tstep.loss_and_grads(card, batch, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    (l1, _p1, g1), (l2, _p2, g2) = runs
    assert torch.equal(l1, l2)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["minicpm-2b", "glm4-9b"])
def test_dense_training_step_at_published_width_is_bitwise_equal(arch):
    """One layer group (one layer) at the published width, bf16, 2 x 512
    tokens: the loss and every gradient leaf of one step, twice, bit for
    bit.  minicpm-2b's tied head adds the head GEMM's gradient to the
    embedding lookup's; glm4-9b repeats 2 KV heads 16 times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import step as tstep
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.period)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tstep.as_trainable(lm.init_params(gen, cfg, device="cuda"))
    batch = tstep.make_train_batch(gen, cfg, 2, 512)
    runs = [tstep.loss_and_grads(params, batch, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    (l1, _p1, g1), (l2, _p2, g2) = runs
    assert torch.isfinite(l1) and torch.equal(l1, l2)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.isfinite(a).all() and float(a.abs().max()) > 0
        assert torch.equal(a, b)


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


# The tensor-core route (csrc/flash_sm90.cu): bf16, D 64, 96 or 128,
# TMA-aligned (D 96 in three 64-byte swizzled boxes a row, the others in
# 128-byte ones).
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
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_matches_plain(gen, s, d, causal):
    b, h, kv = (1, 2, 2) if s == 4096 else (2, 4, 2)
    q = _bf16(gen, b, s, h, d)
    k, v = _bf16(gen, b, s, kv, d), _bf16(gen, b, s, kv, d)
    out = _check_tc(q, k, v, causal)
    # no atomics, sums in a fixed order: a second launch gives the same bits
    assert torch.equal(aops.flash_attention(q, k, v, causal=causal), out)


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_gqa_32_on_2(gen, d, causal):
    q = _bf16(gen, 1, 600, 32, d)
    k, v = _bf16(gen, 1, 600, 2, d), _bf16(gen, 1, 600, 2, d)
    _check_tc(q, k, v, causal)


@pytest.mark.parametrize("sq,sk", [(300, 130), (130, 300), (1, 257),
                                   (257, 1)])
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_unequal_lengths(gen, sq, sk, d, causal):
    q = _bf16(gen, 2, sq, 4, d)
    k, v = _bf16(gen, 2, sk, 2, d), _bf16(gen, 2, sk, 2, d)
    _check_tc(q, k, v, causal)


@pytest.mark.parametrize("d", [64, 96, 128])
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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_internvl2_heads_48_on_8(gen, causal):
    """InternVL2-26B's layout: 48 query heads on 8 KV heads of 128."""
    q = _bf16(gen, 2, 700, 48, 128)
    k, v = _bf16(gen, 2, 700, 8, 128), _bf16(gen, 2, 700, 8, 128)
    _check_tc(q, k, v, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_tc_route_musicgen_padded_heads(gen, causal):
    """MusicGen-medium's layout: 24 heads of 64 padded to 32, its KV heads
    with them.  The kernel attends on all 32 (the padded heads' weights are
    drawn like the others); the decoder masks the padded heads' outputs
    after it (``layers._head_mask``)."""
    q, k, v = (_bf16(gen, 2, 700, 32, 64) for _ in range(3))
    _check_tc(q, k, v, causal)


# -- the MoE FFN, the Mamba mixer and the six archs that use them: the card
# against the same code on the host (the plain PyTorch of models/moe.py and
# models/mamba.py; attention through the flash kernel on the card)


def _host_and_card(arch, seed=0, **change):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime import backend
    from repro_torch.tree import tree_map

    backend.load("cuda")  # fp32 matmul at "highest"
    cfg = dataclasses.replace(get_smoke_config(arch), **change)
    host = lm.init_params(torch.Generator().manual_seed(seed), cfg,
                          device="cpu")
    return cfg, host, tree_map(lambda t: t.cuda(), host)


def _sub(params, kind):
    for sub in params["layers"].values():
        if kind in sub:
            return {k: v[0] for k, v in sub[kind].items()}
    raise KeyError(kind)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("cf,moe_chunk", [(0.5, 1024), (0.5, 8), (64.0, 8)])
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_ffn_on_the_card_matches_the_host(gen, arch, cf, moe_chunk,
                                              no_drop):
    from repro_torch.models import moe

    cfg, host, card = _host_and_card(arch, capacity_factor=cf,
                                     moe_chunk=moe_chunk)
    hm, cm = _sub(host, "moe"), _sub(card, "moe")
    x = torch.randn(2, 48, cfg.d_model, generator=gen)
    y_h, aux_h = moe.moe_ffn(hm, x, cfg, no_drop=no_drop)
    y_c, aux_c = moe.moe_ffn(cm, x.cuda(), cfg, no_drop=no_drop)
    ids_h, keep_h = moe.routing(hm, x, cfg, no_drop=no_drop)
    ids_c, keep_c = moe.routing(cm, x.cuda(), cfg, no_drop=no_drop)
    torch.cuda.synchronize()
    assert torch.equal(ids_c.cpu(), ids_h) and torch.equal(keep_c.cpu(),
                                                           keep_h)
    assert torch.allclose(y_c.cpu(), y_h, rtol=1e-5, atol=1e-5)
    assert abs(float(aux_c) - float(aux_h)) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_two_launches_on_the_card_are_bitwise_equal(gen, dtype):
    """The combine adds each token's k outputs in a fixed order (no float
    atomics): the same input gives the same bits."""
    from repro_torch.models import moe

    cfg, _host, card = _host_and_card("olmoe-1b-7b", capacity_factor=0.5)
    cm = {k: v.to(dtype) for k, v in _sub(card, "moe").items()}
    x = torch.randn(2, 64, cfg.d_model, generator=gen).to("cuda", dtype)
    a, aux_a = moe.moe_ffn(cm, x, cfg)
    b, aux_b = moe.moe_ffn(cm, x, cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("length", [32, 13])
def test_mamba_on_the_card_matches_the_host(gen, chunk, length):
    """mamba_block with its states, then mamba_decode_step chained."""
    from repro_torch.models import mamba

    cfg, host, card = _host_and_card("falcon-mamba-7b", ssm_chunk=chunk)
    hm, cm = _sub(host, "mamba"), _sub(card, "mamba")
    x = torch.randn(2, length + 4, cfg.d_model, generator=gen)
    out_h = mamba.mamba_block(hm, x[:, :length], cfg, return_state=True)
    out_c = mamba.mamba_block(cm, x[:, :length].cuda(), cfg,
                              return_state=True)
    for a, b in zip(out_c, out_h):
        assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5)
    assert out_c[2].dtype == torch.float32
    (_yh, conv_h, ssm_h), (_yc, conv_c, ssm_c) = out_h, out_c
    for t in range(length, length + 4):
        yh, conv_h, ssm_h = mamba.mamba_decode_step(hm, x[:, t:t + 1], cfg,
                                                    conv_h, ssm_h)
        yc, conv_c, ssm_c = mamba.mamba_decode_step(cm, x[:, t:t + 1].cuda(),
                                                    cfg, conv_c, ssm_c)
        for a, b in ((yc, yh), (conv_c, conv_h), (ssm_c, ssm_h)):
            assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-medium",
                                  "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
                                  "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_families_serve_on_the_card_like_the_host(gen, arch):
    """A smoke config's prefill (with its prefix for a stub frontend) and
    greedy decode on the card against the host: logits within 1e-4 of the
    largest, tokens equal, one flash launch an attention layer."""
    from repro_torch.models import frontends, lm

    cfg, host, card = _host_and_card(arch)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=gen)
    pe = frontends.synthetic_prefix(gen, cfg, 2, dtype=torch.float32)
    n_attn = cfg.n_groups * sum(m == "attn" for m, _ff in cfg.pattern)
    outs = []
    for params, dev in ((host, "cpu"), (card, "cuda")):
        before = aops.flash_attention.launches
        max_seq = 20 + cfg.prefix_len + 4
        logits, cache = lm.prefill_step(
            params, toks.to(dev), cfg, max_seq=max_seq,
            prefix_embeds=None if pe is None else pe.to(dev))
        launched = aops.flash_attention.launches - before
        assert launched == (n_attn if dev == "cuda" else 0)
        seq, stream = max_seq - 4, [logits.cpu()]
        for i in range(4):
            tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            logits, cache = lm.decode_step(params, cache, tok, seq + i, cfg)
            stream.append(logits.cpu())
        outs.append(stream)
    for h, c in zip(*outs):
        h, c = h[..., :cfg.vocab], c[..., :cfg.vocab]
        assert float((h - c).abs().max()) <= 1e-4 * float(h.abs().max())
        assert torch.equal(h.argmax(-1), c.argmax(-1))


def test_fused_kernel_keeps_a_nan_row_in_its_own_centroid(gen):
    """NaN input splits the lanes on purpose: the kernel (``cuda-kernel``)
    adds a NaN row to its own centroid's sums only, where the plain
    version (``torch-ref``) spreads its NaN coordinate to every centroid
    through the one-hot product (0 x NaN).  The assignments and counts
    agree, as do the sums of every coordinate the NaN does not touch.
    No admission check stands in front of either, as in the reference."""
    x = torch.randn(128, 4, generator=gen) * 3
    x[7, 0] = float("nan")
    c = torch.randn(2, 4, generator=gen) * 3
    x, c = x.cuda(), c.cuda()
    mask = torch.ones(128, dtype=torch.bool, device="cuda")
    idx, sums, counts, _ = fops.fused_masked_assign_update(x, c, mask)
    ridx, rsums, rcounts, _ = dref.fused_masked_assign_update_ref(x, c, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(counts, rcounts)
    own = int(idx[7])
    assert own == 0                      # an all-NaN score row: index 0
    assert torch.isnan(sums[own, 0]) and torch.isfinite(sums[1 - own]).all()
    assert torch.isnan(rsums[:, 0]).all()
    assert torch.allclose(sums[:, 1:], rsums[:, 1:], rtol=1e-5, atol=1e-5)


def test_card_fleet_labels_equal_a_single_process_service(gen, tmp_path):
    """Two worker processes on the one card, each with its own CUDA
    context, give the labels of a single-process service on the card, bit
    for bit per content hash, every request on ``cuda-kernel``; the
    workers' own counters show the kernels launched there."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.service import (ClusteringService, MiningClient,
                                     content_key)
    from repro_torch.service.fleet import FleetRouter, WorkerManager

    _build.build_all()        # the workers load what this process built
    rng = np.random.default_rng(0)
    work = []
    for i in range(6):
        algo = "kmeans" if i % 3 else "dbscan"
        x = (rng.normal(size=(2048, 4)) * 0.3
             + rng.integers(0, 8, size=(2048, 1)) * 4).astype(np.float32)
        params = ({"k": 8, "seed": i, "max_iters": 30} if algo == "kmeans"
                  else {"eps": 2.0, "min_pts": 40})
        work.append((f"t{i}", algo, x, params))
    cfg = {"max_batch": 4, "max_wait_s": 0.005, "bucket_policy": "pow2"}
    svc = ClusteringService(str(tmp_path / "single"), device="cuda", **cfg)
    client = MiningClient(service=svc)
    with svc:
        handles = [client.submit(t, a, x, params=p, executor="cuda-kernel")
                   for t, a, x, p in work]
        single = {h.cache_key: h.result(300) for h in handles}
    manager = WorkerManager(str(tmp_path / "fleet"), 2, worker_config=cfg,
                            heartbeat_interval=0.25)
    manager.start()
    router = FleetRouter(manager)
    try:
        handles = [(content_key(a, p, x),
                    router.submit(t, a, x, params=p, executor="cuda-kernel"))
                   for t, a, x, p in work]
        for key, h in handles:
            got = h.result(300)
            assert got["executor"] == "cuda-kernel"
            assert np.array_equal(got["labels"], single[key]["labels"])
        snap = router.metrics_snapshot()["workers"]
        launches = {n: s["kernel_launches"] for n, s in snap.items()}
        total = {k: sum(v[k] for v in launches.values())
                 for k in ("fused_masked_assign_update", "epsilon_degree",
                           "expand_frontier")}
        assert all(v > 0 for v in total.values()), launches
    finally:
        router.close()
        manager.stop()


# -- the dry-run clustering step and the pipeline, on the card ----------------


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_dryrun_clustering_step_kernel_route_equals_the_plain_route(gen,
                                                                    shards):
    from repro_torch.core.distributed import Mesh, clustering_step_for_dryrun
    from repro_torch.core.kmeans import KMeansConfig

    # d = 128 takes the wide search; k = 300 is more centroids than one
    # range of sums holds (acc_k = 256), as at the pod-scale cell's k; the
    # shards of the repeated card run on side streams
    x = (torch.randn(40000, 128, generator=gen) * 3).cuda()
    c = x[:300].clone()
    mesh = Mesh((torch.device("cuda:0"),) * shards)
    before = fops.fused_masked_assign_update.launches
    a, cn, shift, inert = clustering_step_for_dryrun(
        KMeansConfig(k=300), mesh)(x, c)
    torch.cuda.synchronize()
    assert fops.fused_masked_assign_update.launches > before
    pa, pcn, pshift, pinert = clustering_step_for_dryrun(
        KMeansConfig(k=300, use_kernel=False), mesh)(x, c)
    assert torch.equal(a, pa)
    torch.testing.assert_close(cn, pcn, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(inert, pinert, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(shift, pshift, rtol=1e-4, atol=1e-4)
    # the shards' passes are the one launch's, bit for bit
    idx, sums, counts, one = fops.fused_masked_assign_update(
        x, c, torch.ones(x.shape[0], dtype=torch.bool, device="cuda"))
    assert torch.equal(a, idx) and torch.equal(inert, one)


def test_pipelined_hidden_forward_equals_the_unpipelined_one(gen):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.distributed import Mesh
    from repro_torch.models import lm
    from repro_torch.parallel.pipeline import pipelined_hidden_forward

    cfg = get_smoke_config("olmo-1b")            # 2 layers
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (3, 2, 16), generator=gen).cuda()
    mesh = Mesh((torch.device("cuda:0"),) * 2, axis="pipe")
    with torch.no_grad():
        before = aops.flash_attention.launches
        out = pipelined_hidden_forward(mesh, params, tokens, cfg)
        torch.cuda.synchronize()
        assert aops.flash_attention.launches == before + 2 * 3
        for i in range(3):
            want, _ = lm.hidden_forward(params, tokens[i], cfg)
            assert torch.equal(out[i], want)
