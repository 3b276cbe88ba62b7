"""The port's program spans and counters (``repro_torch.runtime.spans``):
the solvers' spans, nested as they run, the host reads counted one for
one, the frontier points counted, and nothing recorded or kept with no
profiler running.

The ``cuda`` test runs the kernel wrappers' spans on the card:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import pytest
import torch

from repro_torch.core import dbscan, kmeans
from repro_torch.core.cancellation import CancellationToken
from repro_torch.runtime import spans

CPU = torch.profiler.ProfilerActivity.CPU
CUDA = torch.profiler.ProfilerActivity.CUDA


def _points(device="cpu"):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(600, 3, generator=gen)
    x[:200] += 6.0
    x[200:400] -= 6.0
    x[-10:] *= 40.0          # far points: noise
    return x.contiguous().to(device)


KM = kmeans.KMeansConfig(k=4, max_iters=7, tol=0.0)
DB = dbscan.DBSCANConfig(eps=0.8, min_pts=5)


def _kmeans(x):
    return kmeans.fit_cancellable(0, x, KM, token=CancellationToken())


def _kmeans_fit(x):
    return kmeans.fit(0, x, kmeans.KMeansConfig(k=4, max_iters=7, tol=-1.0))


def _dbscan(x):
    return dbscan.fit_cancellable(x, DB, token=CancellationToken())


SOLVERS = {"kmeans": _kmeans, "kmeans_fit": _kmeans_fit, "dbscan": _dbscan}


def _profiled(fn, x, acts=(CPU,)):
    """(result, the program's spans as (name, start, end), counts)."""
    with torch.profiler.profile(activities=list(acts)) as prof:
        result = fn(x)
    got = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.name.startswith("repro_torch.")
                  and e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda iv: (iv[1], -iv[2]))
    return result, got, spans.counts()


def _parent(ivs, child, parents):
    """The innermost of the spans named in ``parents`` that holds
    ``child``, or None."""
    holders = [iv for iv in ivs if iv[0] in parents and iv is not child
               and iv[1] <= child[1] and child[2] <= iv[2]]
    return max(holders, key=lambda iv: iv[1])[0] if holders else None


def _named(ivs, name):
    return [iv for iv in ivs if iv[0] == name]


@pytest.mark.parametrize("solver", ["kmeans", "kmeans_fit"])
def test_kmeans_spans_nest(solver):
    _, ivs, _ = _profiled(SOLVERS[solver], _points())
    fits = _named(ivs, "repro_torch.kmeans.fit")
    steps = _named(ivs, "repro_torch.kmeans.step")
    assert len(fits) == 1 and len(steps) == 7
    assert len(_named(ivs, "repro_torch.kmeans.update")) == 7
    inner = {"repro_torch.kmeans.step", "repro_torch.kmeans.update"}
    for iv in ivs:
        if iv[0] == "repro_torch.kmeans.step":
            assert _parent(ivs, iv, {"repro_torch.kmeans.fit"})
        elif iv[0] == "repro_torch.kmeans.update":
            assert _parent(ivs, iv, inner) == "repro_torch.kmeans.step"
    # the inertia's first value copied to the card, then the shift's read
    # at the end of each step, after its update
    syncs = [_parent(ivs, iv, inner) for iv in _named(ivs, spans.SYNC)]
    assert syncs == [None] + ["repro_torch.kmeans.step"] * 7
    assert all(_parent(ivs, iv, {"repro_torch.kmeans.fit"})
               for iv in _named(ivs, spans.SYNC))


def test_dbscan_spans_nest():
    result, ivs, _ = _profiled(_dbscan, _points())
    fit = _named(ivs, "repro_torch.dbscan.fit")
    assert len(fit) == 1
    expands = _named(ivs, "repro_torch.dbscan.expand")
    assert len(expands) == int(result.expansions) > 0
    clusters = int(result.n_clusters)
    assert clusters >= 2
    # a seed span for each cluster, and the one that finds no core left
    assert len(_named(ivs, "repro_torch.dbscan.seed")) == clusters + 1
    finish = _named(ivs, "repro_torch.dbscan.finish")
    assert len(finish) == 1
    body = {"repro_torch.dbscan.expand", "repro_torch.dbscan.seed",
            "repro_torch.dbscan.finish"}
    for iv in ivs:
        if iv[0] in body:
            assert _parent(ivs, iv, {"repro_torch.dbscan.fit"})
            assert _parent(ivs, iv, body) is None
    syncs = _named(ivs, spans.SYNC)
    assert all(_parent(ivs, iv, {"repro_torch.dbscan.fit"}) for iv in syncs)
    # pack_state's labels.max() is the finish span's one read
    assert [_parent(ivs, iv, body) for iv in syncs].count(
        "repro_torch.dbscan.finish") == 1
    # the seed span reads whether a core point is left, then the index,
    # and copies True to the card
    assert [_parent(ivs, iv, body) for iv in syncs].count(
        "repro_torch.dbscan.seed") == 3 * clusters + 1


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_sync_spans_are_the_counted_reads(solver):
    _, ivs, counts = _profiled(SOLVERS[solver], _points())
    assert counts["host_syncs"] == len(_named(ivs, spans.SYNC)) > 0


def test_dbscan_syncs_follow_the_loop():
    """A read for each frontier check (one an expansion, one to end each
    cluster, one before the first seed), three syncs for each seed (is a
    core point left, its index, True copied to the card) and one read for
    the search that finds no core point left, and pack_state's read."""
    result, _, counts = _profiled(_dbscan, _points())
    e, c = int(result.expansions), int(result.n_clusters)
    assert counts["host_syncs"] == (e + c + 1) + (3 * c + 1) + 1


def test_frontier_points_are_core_points_plus_clusters():
    result, _, counts = _profiled(_dbscan, _points())
    core = int(result.core_mask.sum())
    clusters = int(result.n_clusters)
    assert 0 < core < 600
    # each seed is expanded alone, then again in its cluster's first
    # frontier; every other core point once
    assert counts["frontier_points"] == core + clusters


def test_no_profiler_records_and_counts_nothing(monkeypatch):
    spans.counts()           # read with the profiler off: a stretch ended
    with torch.profiler.profile(activities=[CPU]):
        spans.count("probe", 3)
    before = spans.counts()
    assert before == {"probe": 3}

    def refuse(*args, **kwargs):
        raise AssertionError("a range recorded with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    x = _points()
    for fn in SOLVERS.values():
        fn(x)
    with spans.span("repro_torch.anything"):
        spans.count("probe")
    assert spans.read(torch.tensor(5)) == 5
    assert spans.counts() == before


def test_a_new_stretch_starts_from_zero():
    x = _points()
    _, _, first = _profiled(_dbscan, x)
    _, _, second = _profiled(_dbscan, x)
    assert second == first
    _, _, km = _profiled(_kmeans, x)
    assert km == {"host_syncs": 1 + 7}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_results_are_bit_equal_with_and_without_a_profiler(solver):
    x = _points()
    plain = SOLVERS[solver](x)
    traced, _, _ = _profiled(SOLVERS[solver], x)
    fields = ("centroids", "labels", "inertia", "iterations", "converged",
              "core_mask", "n_clusters", "expansions")
    for f in fields:
        if hasattr(plain, f):
            assert torch.equal(getattr(plain, f), getattr(traced, f)), f


def test_a_cancelled_dbscan_counts_what_it_expanded():
    token = CancellationToken()
    seen = []

    def stop_after_two(cid, nexp):
        seen.append(nexp)
        if nexp == 2:
            token.cancel()

    with torch.profiler.profile(activities=[CPU]):
        result, snap = dbscan.fit_resumable(_points(), DB, token,
                                            on_progress=stop_after_two)
    counts = spans.counts()
    assert result.cancelled and snap is not None
    assert int(result.expansions) == 2 and seen == [1, 2]
    # the first cluster's seed alone, then its neighbours
    assert counts["frontier_points"] >= 2
    # the empty first frontier's check, the seed's three, a check before
    # each expansion and the one that finds the token cancelled, then the
    # finish's and the snapshot's pack_state
    assert counts["host_syncs"] == 1 + 3 + 3 + 2


@pytest.mark.cuda
def test_kernel_wrapper_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = _points("cuda")
    for fn, wrappers in ((_kmeans, {"repro_torch.kernels.assign_clusters",
                                    "repro_torch.kernels.lloyd_sums"}),
                         (_dbscan, {"repro_torch.kernels.epsilon_degree",
                                    "repro_torch.kernels.expand_frontier"})):
        plain = fn(x)
        torch.cuda.synchronize()
        result, ivs, counts = _profiled(fn, x, (CPU, CUDA))
        assert torch.equal(plain.labels, result.labels)
        assert counts["host_syncs"] == len(_named(ivs, spans.SYNC))
        launched = {iv[0] for iv in ivs
                    if iv[0].startswith("repro_torch.kernels.")}
        assert launched == wrappers
        for iv in ivs:
            if iv[0] in wrappers:
                assert _parent(ivs, iv, {"repro_torch.kmeans.step",
                                         "repro_torch.dbscan.fit"})
