"""A cell of a kind the benchmark has not seen is added by new files and
entries alone.

In a copy of ``portbench/`` and ``BENCHMARK.json``, a stand-in
algorithm whose inputs are not blobs (a row map: rows times a weight
matrix that every job shares) brings its configuration, generator,
traffic mix, entry, check (``small``, ``control``, ``check``), per-layer
reader, cell limits and a test of its own.  The copy's spec tests, its
result-line test over the new cell and the stand-in's test then pass, and
no file that was there changed; ``BENCHMARK.json`` only grew.  Besides,
no harness file outside the algorithms' own names an algorithm."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import spec

from portbench.tests.sizes import ROOT

CELL = "standin-rows.apply"

FILES = {
    "configs/standin-rows.json": json.dumps({
        "name": "standin-rows",
        "algorithm": "rowmap",
        "width": 64,
        "dtype": "float32",
        "data": {"generator": "gauss_rows", "rows": 4096,
                 "about": "standard normal rows and a shared weight matrix"},
    }),
    "generators/gauss_rows.py": '''
import torch


def dataset(config, gen):
    return torch.randn((config["data"]["rows"], config["width"]),
                       generator=gen, device=gen.device)


def shared(config, gen):
    w = config["width"]
    return torch.randn((w, w), generator=gen, device=gen.device) / w ** 0.5


def check(config):
    if config["data"]["rows"] < 1 or config["width"] < 1:
        raise ValueError("rows and width must be positive")
''',
    "traffic/rowmap-3.json": json.dumps({
        "entry": "rowmap_apply", "datasets": 3,
        "about": "one client maps the rows of 3 datasets back to back"}),
    "entries/rowmap_apply.py": '''
from portbench import drive


class Entry(drive.Entry):

    def run(self, j):
        return self.data[self.dataset(j)] @ self.shared

    def fetch(self, result, keep):
        return {"y": self.host("y", result, keep)}

    def counters(self, result):
        return {"rows": int(result.shape[0])}
''',
    "checks/rowmap.py": '''
def gap(y, x, w):
    ref = x.double() @ w.double()
    return float((y.double() - ref).abs().max() / ref.abs().max())


def small(config):
    return dict(config, data=dict(config["data"], rows=256))


def control(config, data, seed, shared=None):
    x = data[0]
    low = (x.bfloat16() @ shared.bfloat16()).float()
    return {"row_gap": gap(low, x, shared)}


def check(entry, config, data, seed, sampled):
    return [{"row_gap": gap(job.answer["y"], data[job.dataset],
                            entry.shared)} for job in sampled]
''',
    "metrics/rows_a_job.py": '''
def read(ctx):
    rows = [job.counters["rows"] for job in ctx.jobs
            if "rows" in job.counters]
    return sum(rows) / len(rows) if rows else None
''',
    f"cells/{CELL}.json": json.dumps({
        "sample": 2,
        "numbers": {"row_gap": {"limit": 1e-4, "lower": 1e-6,
                                "upper": 1e-3}},
        "readings": "a stand-in of the host tests"}),
    "tests/test_standin.py": '''
import portbench
from portbench import readings, spec
from portbench.tests.sizes import ROOT, small_config


def test_the_copy_is_imported():
    assert portbench.__file__.startswith(str(ROOT))


def test_program_under_and_control_over_the_limit():
    limit = spec.limits("standin-rows.apply")["numbers"]["row_gap"]["limit"]
    for r in readings.readings("standin-rows.apply", [1, 2], [1, 2],
                               device="cpu",
                               config=small_config("standin-rows")):
        over = r["numbers"]["row_gap"] > limit
        assert over == (r["side"] == "control"), r
''',
}

ENTRIES = {
    "configs": {"name": "standin-rows",
                "source": "https://example.org/standin-rows",
                "file": "portbench/configs/standin-rows.json",
                "reduced": [], "why": "a stand-in whose inputs are no blobs"},
    "workloads": {"name": CELL, "config": "standin-rows",
                  "traffic": "rowmap-3", "chips": 1,
                  "why": "a closed loop of row maps over 3 datasets"},
    "per_layer": {"name": "rows_a_job", "unit": "rows", "better": "higher",
                  "source": "program_counter", "layer": "Stand-in",
                  "moves": "job_s", "workloads": [CELL]},
}


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_kind_by_new_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(tmp_path / "portbench")
    old = json.loads((tmp_path / "BENCHMARK.json").read_text())

    for rel, text in FILES.items():
        path = tmp_path / "portbench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads(json.dumps(old))
    for group, entry in ENTRIES.items():
        bench[group].append(entry)
    for m in bench["per_layer"]:
        if m["name"] == "device_idle":
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-p", "no:randomly", "portbench/tests/test_portbench_spec.py",
         "portbench/tests/test_portbench_run.py::test_result_line",
         "portbench/tests/test_standin.py", "-k",
         "not result_line or standin"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    # the new cell's pieces found, its result lines (traced and not)
    # correct, its control over its limit and its program under it
    for test in (f"test_cell_finds_its_pieces[{CELL}]",
                 f"test_result_line[False-{CELL}]",
                 f"test_result_line[True-{CELL}]",
                 "test_program_under_and_control_over_the_limit"):
        assert f"{test} PASSED" in out.stdout, out.stdout[-4000:]

    after = _files(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(FILES)
    _only_grew(old, json.loads((tmp_path / "BENCHMARK.json").read_text()))


def _only_grew(old, new) -> None:
    """``new`` holds ``old`` whole: its lists begin with old's items, its
    objects hold old's keys with old's values, each grown the same way."""
    if isinstance(old, list):
        assert isinstance(new, list) and len(new) >= len(old)
        for a, b in zip(old, new):
            _only_grew(a, b)
    elif isinstance(old, dict):
        assert isinstance(new, dict) and set(old) <= set(new)
        for k in old:
            _only_grew(old[k], new[k])
    else:
        assert old == new


def test_no_harness_file_names_an_algorithm():
    algorithms = {spec.config(spec.benchmark(), c["name"])["algorithm"]
                  for c in spec.benchmark()["configs"]}
    harness = sorted((ROOT / "portbench").glob("*.py")) + [
        ROOT / "portbench" / "tests" / "sizes.py"]
    for path in harness:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant):
                assert node.value not in algorithms, (path.name, node.value)
