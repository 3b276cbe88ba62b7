"""The one-job Lloyd step's narrow-row sums on the host: the plain model of
``csrc/fused.cu``'s ``lloyd_sums_kernel`` order, its launch shape, and the
rule by which ``core/kmeans.py`` routes a step's update to it.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``-k lloyd``), held there to :func:`ref.lloyd_sums_ref` bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import kmeans
from repro_torch.kernels.distance import fused, ref

U = 2.0 ** -24  # fp32's unit roundoff


def _inputs(n, k, d, seed, empty=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * 4
    idx = torch.randint(0, k, (n,), generator=g, dtype=torch.int32)
    if empty and k > 1:
        idx[idx == k - 1] = 0          # centroid k - 1 has no rows
    return x, idx


def _depth(n, blocks):
    """Additions on the longest path to a sum: a thread's rows, the xor
    tree, the warps, pass 2's run of blocks and its runs."""
    return (-(-n // (blocks * ref.LLOYD_THREADS)) + 5 + 7
            + -(-blocks // ref.REDUCE_RUNS) + ref.REDUCE_RUNS - 1)


# n not a multiple of a block, n below a warp, k = 1, d = 1, an empty
# cluster, k and d at their limits, the examples' shapes (quickstart's
# 6,144 points of 2 features in 6 clusters; mine_cluster's grid)
LLOYD_CASES = [(1000, 8, 4), (300, 5, 3), (17, 3, 2), (5, 1, 1),
               (3, 4, 4), (4097, 1, 1), (70001, 8, 1), (70001, 8, 3),
               (70001, 1, 4), (6144, 6, 2), (30001, 4, 2),
               (20001, 7, 4)]


@pytest.mark.parametrize("n,k,d", LLOYD_CASES)
def test_lloyd_model_is_fp32_rounding_of_the_exact_sums(n, k, d):
    x, idx = _inputs(n, k, d, seed=n + k + d)
    blocks = fused.lloyd_blocks(n)
    sums, counts = ref.lloyd_sums_ref(x, idx, k, blocks)
    onehot = (idx[:, None].long() == torch.arange(k)).double()
    exact = onehot.T @ x.double()
    scale = onehot.T @ x.double().abs()
    assert torch.equal(counts.double(), onehot.sum(0))
    if k > 1:
        assert int(counts[k - 1]) == 0 and bool((sums[k - 1] == 0).all())
    # a sum over a path of m additions is within m u sum |x| of the exact
    assert bool(((sums.double() - exact).abs()
                 <= 1.01 * _depth(n, blocks) * U * scale).all())
    # and within fp32 rounding of the one-hot product it replaces
    psums, pcounts = kmeans._weighted_sums(x, idx, k)
    assert torch.equal(counts, pcounts)
    assert bool(((sums - psums).abs() <= 1e-5 * scale.float() + 1e-6).all())


def _kernel_order(x, idx, k, blocks):
    """The kernel's order spelled out one addition at a time in numpy fp32:
    an independent statement of what :func:`ref.lloyd_sums_ref` vectorises."""
    x = x.numpy()
    idx = idx.numpy()
    n, d = x.shape
    threads = blocks * ref.LLOYD_THREADS
    f32 = np.float32
    acc = np.zeros((threads, k, d), f32)
    cnt = np.zeros((threads, k), np.int64)
    for t in range(threads):
        for r in range(t, n, threads):
            j = idx[r]
            for f in range(d):
                acc[t, j, f] = f32(acc[t, j, f] + x[r, f])
            cnt[t, j] += 1
    part = np.zeros((blocks, k * d + k + 1), f32)
    for b in range(blocks):
        warps = []
        for w in range(ref.LLOYD_THREADS // 32):
            lanes = acc[b * ref.LLOYD_THREADS + 32 * w:][:32].copy()
            for o in (16, 8, 4, 2, 1):
                lanes = np.array([lanes[i] + lanes[i ^ o] for i in range(32)],
                                 f32)
            warps.append(lanes[0])
        s = warps[0]
        for w in warps[1:]:
            s = (s + w).astype(f32)
        part[b, :k * d] = s.reshape(-1)
        part[b, k * d:k * d + k] = cnt[b * ref.LLOYD_THREADS:][
            :ref.LLOYD_THREADS].sum(0)
    out = np.zeros(k * d + k + 1, f32)
    for w in range(ref.REDUCE_RUNS):
        run = np.zeros(k * d + k + 1, f32)
        for b in range(w * blocks // ref.REDUCE_RUNS,
                       (w + 1) * blocks // ref.REDUCE_RUNS):
            run = (run + part[b]).astype(f32)
        out = run if w == 0 else (out + run).astype(f32)
    return out[:k * d].reshape(k, d), out[k * d:k * d + k]


@pytest.mark.parametrize("n,k,d,blocks", [(1500, 3, 2, 2), (700, 1, 1, 3),
                                          (40, 5, 4, 1), (2100, 2, 3, 9)])
def test_lloyd_model_adds_in_the_kernels_order(n, k, d, blocks):
    x, idx = _inputs(n, k, d, seed=7)
    # magnitudes far apart in every run of rows, so another order would
    # round otherwise
    g = torch.Generator().manual_seed(n)
    x = x * torch.logspace(-6, 6, n)[torch.randperm(n, generator=g), None]
    part = ref.lloyd_partials_ref(x, idx, k, blocks)
    assert part.shape == (blocks, k * d + k + 1)
    assert bool((part[:, -1] == 0).all())
    sums, counts = ref.lloyd_sums_ref(x, idx, k, blocks)
    esums, ecounts = _kernel_order(x, idx, k, blocks)
    assert np.array_equal(sums.numpy().view(np.int32), esums.view(np.int32))
    assert np.array_equal(counts.numpy(), ecounts)


@pytest.mark.parametrize("n", [0, 1, 31, 255, 256, 257, 67583, 67584,
                               67585, 1 << 20, 1 << 24])
def test_lloyd_launch_shape_is_a_function_of_n(n):
    blocks = fused.lloyd_blocks(n)
    assert blocks == fused.lloyd_blocks(n)
    assert 1 <= blocks <= fused.LLOYD_MAX_BLOCKS
    # every block but an empty problem's has a first row
    assert n == 0 or (blocks - 1) * ref.LLOYD_THREADS < n
    # the grid fills up before it caps
    if n >= fused.LLOYD_MAX_BLOCKS * ref.LLOYD_THREADS:
        assert blocks == fused.LLOYD_MAX_BLOCKS


def test_lloyd_sums_on_the_host_is_the_model():
    x, idx = _inputs(5000, 8, 4, seed=3)
    sums, counts = fused.lloyd_sums(x, idx, 8)
    rsums, rcounts = ref.lloyd_sums_ref(x, idx, 8, fused.lloyd_blocks(5000))
    assert torch.equal(sums, rsums) and torch.equal(counts, rcounts)
    zs, zc = fused.lloyd_sums(x[:0], idx[:0], 3)
    assert torch.equal(zs, torch.zeros(3, 4)) and torch.equal(zc,
                                                              torch.zeros(3))


def test_lloyd_sums_refuses_what_it_does_not_take():
    x, idx = _inputs(100, 4, 4, seed=1)
    with pytest.raises(TypeError):
        fused.lloyd_sums(x.double(), idx, 4)
    with pytest.raises(TypeError):
        fused.lloyd_sums(x, idx.long(), 4)
    with pytest.raises(ValueError, match="idx"):
        fused.lloyd_sums(x, idx[:99], 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused.lloyd_sums(x.t().contiguous().t(), idx, 4)
    with pytest.raises(ValueError, match="narrow-row"):
        fused.lloyd_sums(x, idx, 9)                # k over 8
    with pytest.raises(ValueError, match="narrow-row"):
        fused.lloyd_sums(x, idx, 0)
    with pytest.raises(ValueError, match="narrow-row"):
        fused.lloyd_sums(torch.zeros(10, 5), idx[:10] * 0, 1)  # d over 4
    big = torch.empty((fused.MAX_ROWS + 1, 1), device="meta")
    with pytest.raises(ValueError, match="narrow-row"):
        fused.lloyd_sums(big, torch.empty(fused.MAX_ROWS + 1,
                                          dtype=torch.int32, device="meta"),
                         2)


class _Form:
    """A stand-in library whose ``lloyd_form`` reports ``form``."""

    def __init__(self, form):
        self.form = form

    def lloyd_form(self, out):
        out[:] = self.form


@pytest.mark.parametrize("form,holds", [
    ((ref.LLOYD_THREADS, ref.LLOYD_MAX_K, ref.LLOYD_MAX_D), True),
    ((128, ref.LLOYD_MAX_K, ref.LLOYD_MAX_D), False),
    ((ref.LLOYD_THREADS, 16, ref.LLOYD_MAX_D), False),
])
def test_the_library_form_is_held_to_the_plain_model(monkeypatch, form,
                                                     holds):
    lib = _Form(form)
    monkeypatch.setattr(fused, "_lib", lambda: lib)
    monkeypatch.setattr(fused, "_lloyd_checked", False)
    if holds:
        assert fused._lloyd_lib() is lib
        assert fused._lloyd_checked
    else:
        with pytest.raises(RuntimeError, match="lloyd_form"):
            fused._lloyd_lib()
        assert not fused._lloyd_checked


@dataclasses.dataclass
class _Rows:
    """What the routing rule reads of x, without a card."""
    shape: tuple
    is_cuda: bool = True
    dtype: torch.dtype = torch.float32
    contiguous: bool = True

    def is_contiguous(self):
        return self.contiguous


@pytest.mark.parametrize("rows,k,use_kernel,takes", [
    (_Rows((1 << 24, 4)), 8, True, True),                    # the cell
    (_Rows((6144, 2)), 6, True, True),                       # quickstart
    (_Rows((1000, 1)), 1, True, True),
    (_Rows((1000, 3)), 7, True, True),
    (_Rows((1000, 4), is_cuda=False), 8, True, False),       # the host
    (_Rows((1000, 4)), 8, False, False),                     # torch-ref
    (_Rows((1000, 4)), 9, True, False),                      # k over 8
    (_Rows((1000, 5)), 1, True, False),                      # d over 4
    (_Rows((1000, 2048)), 4, True, False),                   # the embedding
    (_Rows((1 << 20, 128)), 4096, True, False),              # IVF4096
    (_Rows(((1 << 24) + 1, 4)), 8, True, False),             # counts round
    (_Rows((1000, 4), dtype=torch.bfloat16), 8, True, False),
    (_Rows((1000, 4), contiguous=False), 8, True, False),
])
def test_the_step_routes_narrow_rows_on_the_card_to_the_kernel(
        rows, k, use_kernel, takes):
    cfg = kmeans.KMeansConfig(k=k, use_kernel=use_kernel)
    assert kmeans._takes_lloyd_kernel(rows, cfg) is takes


def test_the_step_and_the_minibatch_step_call_the_kernel_when_routed(
        monkeypatch):
    calls = []

    def fake(x, assign, k):
        calls.append((x.shape, assign.dtype, k))
        return kmeans._weighted_sums(x, assign, k)

    x, _ = _inputs(600, 4, 3, seed=5)
    c = x[:4].clone()
    cfg = kmeans.KMeansConfig(k=4)
    plain = kmeans.kmeans_step(x, c, cfg)
    monkeypatch.setattr(kmeans, "lloyd_sums", fake)
    assert kmeans.kmeans_step(x, c, cfg)[1].equal(plain[1])
    assert calls == []                     # CPU tensors keep the product
    monkeypatch.setattr(kmeans, "_takes_lloyd_kernel", lambda x, cfg: True)
    routed = kmeans.kmeans_step(x, c, cfg)
    assert calls == [((600, 3), torch.int32, 4)]
    for a, b in zip(routed, plain):
        assert torch.equal(a, b)
    state = kmeans.MiniBatchState(centroids=c, counts=torch.zeros(4))
    kmeans.minibatch_step(state, x[:100], cfg)
    assert calls[-1] == ((100, 3), torch.int32, 4)
