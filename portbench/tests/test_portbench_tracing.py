"""The trace's reduction on a hand-made trace: the device's busy time,
the kernel tables, the calls' leading packs, and the idle gaps' labels."""

import pytest

from portbench import kernel_names, tracing


def _trace():
    device = [
        ("pack_points(float const*)", 0.0, 1.0),
        ("void degree_tri_kernel<2, 2>(Args)", 1.0, 11.0),
        ("pack_points(float const*)", 15.0, 16.0),
        ("gather_frontier(unsigned char const*)", 16.0, 17.0),
        ("void neighbor_kernel<2, 2, true>(Args)", 17.0, 20.0),
        ("Memcpy DtoH (Device -> Pinned)", 30.0, 31.0),
    ]
    host = [("portbench.job", 0.0, 40.0), ("aten::item", 22.0, 31.0),
            ("aten::_local_scalar_dense", 23.0, 31.0)]
    return tracing.Trace(device, host, 0.0, 40.0)


def test_busy_is_the_union():
    tr = _trace()
    assert tr.window_s == pytest.approx(40e-6)
    assert tr.busy_s == pytest.approx(17e-6)
    assert tracing.union_us([("a", 0, 2), ("b", 1, 3), ("c", 5, 6)]) == 4


def test_leads_go_with_the_call_that_follows():
    tr = _trace()
    deg = tracing.with_leads(tr.device, kernel_names.DEGREE,
                             kernel_names.NEIGHBOR_LEAD, kernel_names.EXPAND)
    exp = tracing.with_leads(tr.device, kernel_names.EXPAND,
                             kernel_names.NEIGHBOR_LEAD, kernel_names.DEGREE)
    assert tracing.union_us(deg) == 11.0
    assert tracing.union_us(exp) == 5.0


def test_names_match_whole_words():
    ops = [("void search_wide_kernel<8>(x)", 0, 1),
           ("void search_wide_kernel_v2(x)", 1, 2),
           ("repro_assign::pack_centroids(float const*)", 2, 3)]
    got = tracing.matching(ops, kernel_names.SEARCH)
    assert [iv[0] for iv in got] == [ops[0][0], ops[2][0]]


def test_idle_gaps_take_the_innermost_host_op():
    b = tracing.breakdown(_trace())
    assert b["device_ops"][0] == ["void degree_tri_kernel<2, 2>(Args)",
                                  pytest.approx(10e-6)]
    gaps = dict(b["idle_gaps"])
    # 11-15 and 20-30 and 31-40: the job's span, then the host's sync
    assert gaps["portbench.job"] == pytest.approx(4e-6 + 9e-6)
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(10e-6)
