"""Finds a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each
configuration, traffic mix, cell's check, input generator, entry driver,
algorithm's comparison and per-layer reader is a file of its own under
``portbench/``.  A later cell, of a kind the benchmark has not seen
before too, adds files and entries and edits none of these.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _read(root / "BENCHMARK.json")


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(e["name"] for e in entries)
    raise KeyError(f"no {what} named {name!r}; BENCHMARK.json has {known}")


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry of a cell."""
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """A configuration's file, as BENCHMARK.json's ``configs`` names it."""
    return _read(root / _named(bench["configs"], name, "config")["file"])


def traffic(name: str) -> dict:
    """The parameters of a traffic mix (``portbench/traffic/<name>.json``)."""
    return _read(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    """The check's sample and limits (``portbench/cells/<cell>.json``)."""
    return _read(HERE / "cells" / f"{cell_name}.json")


def metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones without a
    trace, the per-layer ones with it; a metric with a ``workloads`` key
    only in the cells it lists."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


@functools.lru_cache(maxsize=None)
def module(folder: str, name: str) -> ModuleType:
    """``portbench/<folder>/<name>.py``, loaded as a module of its own."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} module {name!r} at {path}")
    mod_name = f"portbench_{folder}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str) -> ModuleType:
    """The reader of a per-layer metric (``portbench/metrics/<name>.py``):
    a module with ``read(ctx) -> float | None``."""
    return module("metrics", metric_name)


def driver(entry_name: str) -> ModuleType:
    """The driver of an entry point (``portbench/entries/<name>.py``): a
    module with ``Entry`` (a :class:`portbench.drive.Entry`) and
    optionally ``loop``, which replaces :func:`portbench.drive.closed_loop`."""
    return module("entries", entry_name)


def comparison(algorithm: str) -> ModuleType:
    """How an algorithm's answers are held to the reference
    (``portbench/checks/<algorithm>.py``): a module with ``check`` (the
    numbers of each sampled job), ``control`` (the same numbers of the
    reference computed in the precision below the configuration's) and
    ``small`` (the configuration cut to a size the host tests run)."""
    return module("checks", algorithm)


def generator(name: str) -> ModuleType:
    """The inputs of a configuration (``portbench/generators/<name>.py``,
    named by its ``data.generator``): a module with ``dataset(config,
    gen)``, one dataset from a ``torch.Generator``, ``check(config)``,
    which raises where the configuration's sizes disagree, and optionally
    ``shared(config, gen)``, the inputs every job of a run shares (a
    model's weights), drawn once in set-up."""
    return module("generators", name)
