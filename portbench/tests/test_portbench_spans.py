"""The readers of the program's spans and counters on a hand-made trace
and counter table: the syncs a job, the idle inside the fit spans, the
wrappers' mean duration and the expansions' roofline; None where the
trace is empty or the program keeps no such counter."""

import sys

import pytest
import torch

from portbench import drive, run, spec, tracing, work
from repro_torch.runtime import spans

NEW = {"host_syncs": ["kmeans-d4.fit", "dbscan-d4.fit"],
       "loop_idle_ms": ["kmeans-d4.fit", "dbscan-d4.fit"],
       "launch_us": ["kmeans-d4.fit", "dbscan-d4.fit"],
       "expand_roofline": ["dbscan-d4.fit"]}
CONFIG = {"points": 1000, "features": 4}


def _table(**counts):
    """The program's counter table, as a profiled stretch leaves it."""
    spans.counts()                        # the profiler seen off
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for name, n in counts.items():
            spans.count(name, n)
    assert spans.counts() == counts


def _ctx(device, host, jobs=1, expansions=0):
    trace = tracing.Trace(device, host, 0.0, 100.0)
    return run.Context(trace, [drive.Job(j, 0, None,
                                         {"expansions": expansions})
                               for j in range(jobs)], CONFIG)


def _read(name, ctx):
    return spec.reader(name).read(ctx)


DEVICE = [("void assign_kernel<8>(Args)", 0.0, 10.0),
          ("void assign_kernel<8>(Args)", 15.0, 20.0),
          ("Memcpy DtoH (Device -> Pageable)", 30.0, 40.0)]


def test_the_entries_as_written():
    bench = spec.benchmark()
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert {k: m["workloads"] for k, m in got.items()} == NEW
    assert [m["name"] for m in bench["per_layer"][-4:]] == list(NEW)
    assert got["launch_us"]["layer"] == "Kernel wrappers (host)"
    assert got["expand_roofline"]["layer"] == "Kernels: DBSCAN"
    assert {m["moves"] for m in got.values()} == {"job_s"}


def test_host_syncs_a_job():
    _table(host_syncs=54, frontier_points=9)
    assert _read("host_syncs", _ctx(DEVICE, [], jobs=2)) == 27.0
    assert _read("host_syncs", _ctx([], [], jobs=2)) is None
    _table(frontier_points=9)
    assert _read("host_syncs", _ctx(DEVICE, [], jobs=2)) is None


def test_readers_read_nothing_from_a_program_without_counters(monkeypatch):
    _table(host_syncs=54, frontier_points=9)
    # the parent of the commit that added the counters: no such module
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    monkeypatch.delattr(sys.modules["repro_torch.runtime"], "spans")
    ctx = _ctx(DEVICE + [("neighbor_kernel<2, 2, true>(x)", 50.0, 60.0)],
               [], expansions=3)
    assert _read("host_syncs", ctx) is None
    assert _read("expand_roofline", ctx) is None


def test_loop_idle_counts_the_gaps_inside_fit_spans_only():
    host = [("portbench.job", 0.0, 45.0),
            ("repro_torch.kmeans.fit", 0.0, 25.0),
            ("repro_torch.kmeans.step", 2.0, 12.0),
            ("repro_torch.sync", 10.0, 15.0)]
    # idle 10-15 and 20-25 inside the fit; 25-30 and 40-45 outside it
    assert _read("loop_idle_ms", _ctx(DEVICE, host)) == pytest.approx(0.010)
    # two jobs, the second a DBSCAN fit over 30-45: 40-45 idle in it too
    host2 = host + [("repro_torch.dbscan.fit", 30.0, 45.0)]
    assert _read("loop_idle_ms", _ctx(DEVICE, host2, jobs=2)) == \
        pytest.approx(0.015 / 2)
    # a fit inside a fit counts once
    nested = host + [("repro_torch.kmeans.fit", 18.0, 24.0)]
    assert _read("loop_idle_ms", _ctx(DEVICE, nested)) == pytest.approx(0.010)
    assert _read("loop_idle_ms", _ctx(DEVICE, host[:1])) is None
    assert _read("loop_idle_ms", _ctx([], host)) is None


def test_launch_us_is_the_wrappers_mean_duration():
    host = [("repro_torch.kmeans.step", 0.0, 90.0),
            ("repro_torch.kernels.assign_clusters", 1.0, 31.0),
            ("repro_torch.kernels.expand_frontier", 40.0, 50.0),
            ("aten::empty", 2.0, 3.0)]
    assert _read("launch_us", _ctx(DEVICE, host)) == pytest.approx(20.0)
    assert _read("launch_us", _ctx(DEVICE, host[:1])) is None
    assert _read("launch_us", _ctx([], host)) is None


def test_expand_roofline_from_a_known_frontier():
    n, d = CONFIG["points"], CONFIG["features"]
    device = [("pack_points(float const*)", 0.0, 1.0),
              ("void degree_tri_kernel<2, 2>(Args)", 1.0, 50.0),
              ("pack_points(float const*)", 60.0, 61.0),
              ("gather_frontier(unsigned char const*)", 61.0, 62.0),
              ("void neighbor_kernel<2, 2, true>(Args)", 62.0, 72.0),
              ("pack_points(float const*)", 80.0, 81.0),
              ("gather_frontier(unsigned char const*)", 81.0, 82.0),
              ("void neighbor_kernel<2, 2, true>(Args)", 82.0, 92.0)]
    _table(frontier_points=1007)
    got = _read("expand_roofline", _ctx(device, [], expansions=2))
    ops, nbytes = 2 * d * n * 1007, 2 * (4 * n * d + 2 * n)
    bound = max(ops / work.PEAK_TF32_FLOPS, nbytes / work.PEAK_HBM_BYTES)
    assert got == pytest.approx(100.0 * bound / 24e-6)
    # the operations bound it here: 8.056e6 of them against 36,000 bytes
    assert ops / work.PEAK_TF32_FLOPS > nbytes / work.PEAK_HBM_BYTES
    assert _read("expand_roofline", _ctx([], [], expansions=2)) is None
    assert _read("expand_roofline", _ctx(device[:2], [], expansions=2)) \
        is None
    _table(host_syncs=3)
    assert _read("expand_roofline", _ctx(device, [], expansions=2)) is None
