"""The benchmark finds every piece of a cell by name, and BENCHMARK.json
keeps to the contract's form."""

import json
import re

import pytest

from portbench import drive, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_names_and_units():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert all(0 < m["bound"] <= 0.25 for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_pieces(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    assert issubclass(spec.driver(traffic["entry"]).Entry, drive.Entry)
    compare = spec.comparison(cfg["algorithm"])
    assert all(callable(getattr(compare, f))
               for f in ("check", "control", "small"))
    gen = spec.generator(cfg["data"]["generator"])
    assert callable(gen.dataset) and callable(gen.check)
    lim = spec.limits(cell)
    assert lim["numbers"] and int(lim["sample"]) >= 1
    assert w["chips"] == 1
    e2e = {m["name"] for m in spec.metrics(BENCH, cell, False)}
    assert {"job_s", "peak_mem_gib", "setup_s"} <= e2e
    per_layer = spec.metrics(BENCH, cell, True)
    assert per_layer
    for m in per_layer:
        assert callable(spec.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = spec.config(BENCH, c["name"])
        assert cfg["name"] == c["name"]
        # held to its own generator's schema (the blobs: the points the
        # work counts use are the points the data draws)
        spec.generator(cfg["data"]["generator"]).check(cfg)
        assert all(key in cfg["data"] or key in cfg for key in c["reduced"])


def test_per_layer_metrics_name_real_cells_and_one_layer_name_each():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(KeyError):
        spec.config(BENCH, "no-such-config")
    with pytest.raises(FileNotFoundError):
        spec.traffic("no-such-mix")
    for find in (spec.driver, spec.comparison, spec.reader, spec.generator):
        with pytest.raises(KeyError):
            find("no-such-piece")
