"""A run's result line, and the runs that must print none."""

import json
import shutil
from collections import Counter
import subprocess
import sys

import pytest

from portbench import drive, run, spec

from portbench.tests.sizes import ROOT, small_config

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    bench = spec.benchmark()
    cfg = small_config(spec.cell(bench, cell)["config"])
    r = run.run_cell(cell, 2**31 + 11, 0.2, trace, device="cpu", config=cfg)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    wanted = {m["name"]: m["unit"] for m in spec.metrics(bench, cell, trace)}
    assert set(r["metrics"]) <= set(wanted)
    if not trace:
        assert set(r["metrics"]) == set(wanted)
    for name, m in r["metrics"].items():
        assert m["unit"] == wanted[name] and isinstance(m["value"], float)
    limits = spec.limits(cell)["numbers"]
    assert set(r["checks"]) == set(limits)
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"] == float(limits[name]["limit"])
    json.dumps(r)


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "kmeans-d4.fit", "--seed", "7", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def _draw(seed, n, count=2):
    r = drive.Reservoir(seed, count)
    for j in range(n):
        slot = r.admit(j)
        if slot is not None:
            r.put(slot, drive.Job(j, 0, {}, {}))
    return [job.index for job in r.jobs()]


def test_reservoir_draws_a_seeded_uniform_sample():
    assert _draw(5, 100) == _draw(5, 100)
    assert len(_draw(5, 100)) == 2 and _draw(5, 1) == [0]
    seen = Counter(i for s in range(2**31, 2**31 + 500) for i in _draw(s, 10))
    # each of 10 jobs is drawn 2 times in 10: 100 of 500 draws, give or take
    assert all(60 < seen[i] < 140 for i in range(10)), seen
