#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up draws the cell's datasets on the card
from the seed, loads the port's kernels (``build/repro_torch/``, built
there by the first run of a checkout) and runs one warm-up job; then the
cell's entry driver (``portbench/entries/<entry>.py``) runs its jobs for
``--seconds`` (by default one client, whole jobs back to back, the job in
flight at the end finished and counted).  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiler over the same window.  Once the window has closed, a sample of
the jobs is held to the plain reference (``portbench/checks/``), and each
number compared is printed beside its limit, last on standard error and
last in the JSON line.

Exits non-zero, printing no result, where there is no CUDA card (or fewer
than the cell asks for), where the port is not beside the benchmark, or
where the process has loaded ``jax``, ``jaxlib``, ``flax`` or ``repro``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Compared by their top-level name, the part before the first dot, as a
# whole: the port's own name, repro_torch, begins with "repro".
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# The warm-up job's index: a stream of its own for its initial centroids.
WARMUP = 1 << 32


def _process_start() -> float:
    """When this process started (Linux), else now."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        start = now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now
    return start if 0.0 <= now - start < 120.0 else now


T_START = _process_start()


def _cache_dirs(root: Path) -> None:
    """Every kernel cache at a fixed place inside the checkout (the port
    builds its own kernels into ``build/repro_torch/``)."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def _paths(root: Path) -> None:
    # run as a script, the folder of this file comes first on the path:
    # its modules are imported as portbench.<name> instead
    if sys.path and Path(sys.path[0] or ".").resolve() == root / "portbench":
        sys.path.pop(0)
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: dict = None,
             t_start: float = None) -> dict:
    """One run of cell ``name``: returns the result line as a dict.

    ``device="cpu"`` (with a small ``config``) runs the same steps on the
    host, through the port's plain versions, for the tests; it reports no
    device numbers."""
    import torch

    from portbench import checks, drive, inputs, spec, tracing

    t_start = time.time() if t_start is None else t_start
    # set-up's phases, printed on standard error: what a later PR cuts
    marks = [("torch", time.time())]
    bench = spec.benchmark()
    cell = spec.cell(bench, name)
    config = config or spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(name)

    from repro_torch.runtime import backend

    dev = backend.load(device).device
    marks.append(("backend", time.time()))
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    data = inputs.datasets(config, seed, int(traffic["datasets"]), dev)
    entry = drive.entry(config, traffic, data, seed,
                        inputs.shared(config, seed, dev))
    sample = drive.Reservoir(seed, int(limits["sample"]))
    marks.append(("data", time.time()))
    entry.run(WARMUP)
    sync()
    marks.append(("warm-up", time.time()))
    traced = trace and cuda
    if traced:
        tracing.warm_profiler()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    print("portbench: set-up " + " ".join(
        f"{what} {b - a:.3f}" for (what, b), (_, a) in
        zip(marks, [("", t_start)] + marks)), file=sys.stderr)

    with tracing.profiled(traced) as prof:
        with tracing.span(tracing.WINDOW):
            jobs, window_s = drive.loop(entry)(entry, seconds, sync, trace,
                                               tracing.span, sample)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    # one job's footprint: the peak less the inputs of the other jobs,
    # which the benchmark keeps resident all through the window
    job_peak = peak - (entry.resident_bytes() - entry.job_bytes())

    out_metrics, extra = {}, {}
    wanted = spec.metrics(bench, name, trace)
    if trace:
        tr = tracing.read(prof) if traced else tracing.Trace([], [], 0.0, 0.0)
        ctx = Context(trace=tr, jobs=jobs, config=config)
        for m in wanted:
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                out_metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
        if traced:
            extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        e2e = {"job_s": window_s / len(jobs),
               "peak_mem_gib": job_peak / 2**30,
               "setup_s": setup_s}
        out_metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                                   "unit": m["unit"]} for m in wanted}
    del prof

    numbers, failed = checks.check(entry, config, data, seed, sample.jobs(),
                                   limits)
    bounds = {k: float(v["limit"]) for k, v in limits["numbers"].items()}
    result = {
        "correct": all(numbers[k] <= bounds[k] for k in bounds),
        "attempted": len(jobs),
        "failed": failed,
        "metrics": out_metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
            **extra,
        },
    }
    if traced:
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = {k: {"value": float(numbers[k]), "limit": bounds[k]}
                        for k in bounds}
    return result


class Context:
    """What a per-layer reader reads: ``trace`` (a ``tracing.Trace``),
    ``jobs`` (each with the program's counters) and ``config``."""

    def __init__(self, trace, jobs, config) -> None:
        self.trace, self.jobs, self.config = trace, jobs, config


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("" without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs(ROOT)
    _paths(ROOT)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the port (src/repro_torch) is not beside the "
              "benchmark", file=sys.stderr)
        return 2
    import torch

    from portbench import spec

    chips = int(spec.cell(spec.benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    result["device"]["power_limit"] = power_limit()
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
