#!/usr/bin/env python3
"""Time the DBSCAN neighbour kernels of this checkout against another's, on
one CUDA card, at the shapes the paths launch.

    python3 scripts/neighbor_ab.py OTHER [--out FILE]

OTHER is the root of another checkout of this repository, for example a
commit unpacked with ``git archive <commit> | tar -x -C OTHER``; each tree
builds its own ``csrc/neighbor.cu`` into its own ``build/``.

The inputs are made once, as ``chip_smoke.py`` makes them: the one-job
path's blobs (n = 65,536, d = 4, eps = 2), the service's first DBSCAN
request padded to its bucket with the far-diagonal pads (n = 16,384) and
n = 2,048 blobs, each with a ~5% frontier.  Each tree's
``repro_torch.kernels.neighbor.ops`` then runs in a process of its own, in
the order OTHER, this, this, OTHER, so that a drift of the card between
runs shows.  Each run holds both kernels to its tree's plain versions
(``torch.equal``) and reads, per shape and kernel, with ``chip_smoke.py``'s
helpers: the CUDA-event mean of the wrapper call (``ms``), the host
microseconds a call with the calls queued and no sync (``host_us``), and
the device time of one call under ``torch.profiler`` (``device_ms``).  The
runs' outputs must be bitwise equal across the two trees.

Then the paths themselves, WALLS times each: ``core.dbscan.fit`` on the
one-job input (host wall to a device sync, no job store) and the service's
DBSCAN workload (``chip_smoke.SVC_DBSCAN``: 8 requests of 14,336-16,384
points) driven through a fresh ``ClusteringService`` on the
``cuda-kernel`` lane (``chip_smoke._drive``'s wall), with the kernels'
launches counted and the labels equal across the trees.

Prints the card (``nvidia-smi``), one JSON line per run, and last a JSON
summary; ``--out`` also writes the summary to a file.  Exits non-zero
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("one-job", "service", "n=2048")
# CUDA-event repetitions a shape (the expansion takes twice as many), as in
# chip_smoke.kernel_neighbor
REPS = {"one-job": 10, "service": 20, "n=2048": 50}
# End-to-end walls a run: the one-job DBSCAN fit and the service's DBSCAN
# workload, each WALLS times (the first of each on a cold path)
WALLS = 4


def make_inputs(out_dir: Path) -> None:
    """Write each shape's x, frontier and eps to out_dir (numpy files)."""
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.data import synthetic as synth
    from repro_torch.launch import serve_mine

    spec = cs.spec_of(synth, cs.DBSCAN_SHAPE)
    x, _, _ = synth.make_blobs(cs.SEED, spec)
    xs, seps = cs._service_dbscan_item({"serve_mine": serve_mine})
    small, _, _ = synth.make_blobs(cs.SEED, synth.ClusterSpec(4, 8, 256))
    cases = {"one-job": (x.numpy(), spec.dbscan_eps),
             "service": (np.asarray(xs, np.float32), seps),
             "n=2048": (small.numpy(), spec.dbscan_eps)}
    for i, (what, (pts, eps)) in enumerate(cases.items()):
        n = pts.shape[0]
        g = torch.Generator().manual_seed(cs.SEED + n)
        front = (torch.rand(n, generator=g) < cs.FRONTIER_FRACTION).numpy()
        np.savez(out_dir / f"in{i}.npz", x=pts, front=front, eps=eps)


def measure(tree: Path, inputs: Path, run: int) -> dict:
    """One run: the tree's wrappers on every shape (in this process)."""
    import numpy as np

    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.neighbor import ops

    cs.check(Path(ops.__file__).resolve().is_relative_to(tree.resolve()),
             f"{ops.__file__} is not from {tree}")
    # the profiler's first window pays its own set-up
    cs.profile_window(torch, "warm-up", lambda: torch.ones(8).cuda() + 1)
    rows = {}
    for i, what in enumerate(SHAPES):
        data = np.load(inputs / f"in{i}.npz")
        x = torch.from_numpy(data["x"]).cuda()
        front = torch.from_numpy(data["front"]).cuda()
        eps = float(data["eps"])
        deg = ops.epsilon_degree(x, eps)
        reach = ops.expand_frontier(x, front, eps)
        cs.check(bool(torch.equal(deg, ops.epsilon_degree_ref(x, eps))),
                 f"{tree}: degree {what} differs from the plain version")
        cs.check(bool(torch.equal(reach, ops.expand_frontier_ref(
            x, front, eps))), f"{tree}: expansion {what} differs")
        np.savez(inputs / f"out{run}_{i}.npz", deg=deg.cpu().numpy(),
                 reach=reach.cpu().numpy())
        calls = {"degree": lambda: ops.epsilon_degree(x, eps),
                 "expansion": lambda: ops.expand_frontier(x, front, eps)}
        for kernel, fn in calls.items():
            reps = REPS[what] * (2 if kernel == "expansion" else 1)
            rows[f"{what} {kernel}"] = dict(
                host_us=cs.host_us(torch, fn),
                ms=cs.time_ms(torch, fn, reps=reps),
                device_ms=cs.profile_window(
                    torch, f"{tree.name} {what} {kernel}", fn)["busy_ms"])
        rows[f"{what} shape"] = dict(n=int(x.shape[0]), d=int(x.shape[1]),
                                     eps=eps, frontier=int(front.sum()))
    rows.update(path_walls(torch, cs, inputs, run))
    return rows


def path_walls(torch, cs, inputs: Path, run: int) -> dict:
    """The one-job fit's and the service DBSCAN workload's walls (s)."""
    import numpy as np
    from repro_torch import service
    from repro_torch.core import dbscan
    from repro_torch.kernels.neighbor import ops
    from repro_torch.launch import serve_mine

    x = torch.from_numpy(np.load(inputs / "in0.npz")["x"]).cuda()
    cfg = dbscan.DBSCANConfig.paper_defaults(x.shape[1])
    fit = [cs.timed_wall(torch, lambda: dbscan.fit(x, cfg))
           for _ in range(WALLS)]
    labels = dbscan.fit(x, cfg).labels.cpu().numpy()
    work = cs._svc_workload(serve_mine, "dbscan", cs.SVC_DBSCAN, cs.SEED + 1)
    mods = dict(serve_mine=serve_mine, service=service)
    walls, launches = [], []
    for _ in range(WALLS):
        with tempfile.TemporaryDirectory(prefix="svc_") as wd:
            svc = cs._svc(mods, wd)
            svc.start()
            before = (ops.epsilon_degree.launches,
                      ops.expand_frontier.launches)
            try:
                results, wall = cs._drive(mods, svc, work, "cuda-kernel")
            finally:
                svc.stop()
        walls.append(wall)
        launches.append([ops.epsilon_degree.launches - before[0],
                         ops.expand_frontier.launches - before[1]])
    cs.check(launches[-1][0] == len(work),
             f"service: {launches[-1][0]} degree launches for {len(work)} "
             f"requests")
    np.savez(inputs / f"labels{run}.npz", fit=labels,
             **{f"svc{i}": r["labels"] for i, r in enumerate(results)})
    return {"one-job fit wall_s": fit, "service DBSCAN wall_s": walls,
            "service DBSCAN launches (degree, expansion)": launches,
            "service DBSCAN profile": profile_drive(torch, cs, mods, work)}


def profile_drive(torch, cs, mods, work, top: int = 12) -> dict:
    """One more drive of the workload under torch.profiler: its wall, the
    device's busy time (kernels, copies, memsets), and the host ops that
    took the most self CPU time (every thread), with their counts."""
    prof_mod = torch.profiler
    acts = [prof_mod.ProfilerActivity.CPU, prof_mod.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="svc_") as wd:
        svc = cs._svc(mods, wd)
        svc.start()
        try:
            with prof_mod.profile(activities=acts) as prof:
                _results, wall = cs._drive(mods, svc, work, "cuda-kernel")
                torch.cuda.synchronize()
        finally:
            svc.stop()
    evts = prof.key_averages()
    device = torch.autograd.DeviceType.CUDA
    busy = sum(cs._device_us(e) for e in evts if e.device_type == device)
    host = sorted((e for e in evts if e.device_type != device),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return dict(wall_s=wall, device_busy_ms=busy / 1e3,
                host_top=[[e.key[:60], e.count,
                           e.self_cpu_time_total / 1e3] for e in host])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", type=Path,
                    help="root of the other checkout")
    ap.add_argument("--out", type=Path, help="also write the summary here")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("neighbor_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.measure is not None:
        rows = measure(args.measure, args.inputs, args.run)
        print("RESULT " + json.dumps(rows), flush=True)
        return 0
    if args.other is None or not (args.other / "src" / "repro_torch").is_dir():
        ap.error("OTHER must be the root of a checkout with src/repro_torch")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    order = [("other", args.other), ("this", ROOT), ("this", ROOT),
             ("other", args.other)]
    runs = []
    with tempfile.TemporaryDirectory(prefix="neighbor_ab_") as tmp:
        inputs = Path(tmp)
        make_inputs(inputs)
        for run, (label, tree) in enumerate(order):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure",
                 str(tree.resolve()), "--inputs", str(inputs), "--run",
                 str(run)], capture_output=True, text=True, timeout=900,
                env=dict(os.environ, PYTHONPATH=""))
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr)
            if proc.returncode != 0:
                print(f"neighbor_ab: run {run} ({label}) failed",
                      file=sys.stderr)
                return 1
            rows = json.loads(proc.stdout.split("RESULT ", 1)[1])
            runs.append(dict(run=run, tree=label, path=str(tree),
                             rows=rows))
            print(json.dumps(runs[-1]), flush=True)
        import numpy as np
        for i, what in enumerate(SHAPES):
            first = np.load(inputs / f"out0_{i}.npz")
            for run in range(1, len(order)):
                out = np.load(inputs / f"out{run}_{i}.npz")
                for key in ("deg", "reach"):
                    if not np.array_equal(first[key], out[key]):
                        print(f"neighbor_ab: {what} {key} of run {run} "
                              f"differs from run 0", file=sys.stderr)
                        return 1
        first = np.load(inputs / "labels0.npz")
        for run in range(1, len(order)):
            out = np.load(inputs / f"labels{run}.npz")
            if sorted(first) != sorted(out) or not all(
                    np.array_equal(first[k], out[k]) for k in first):
                print(f"neighbor_ab: the labels of run {run} differ from "
                      f"run 0", file=sys.stderr)
                return 1
    summary = dict(card=card, order=[label for label, _ in order],
                   runs={k: {label: [r["rows"][k] for r in runs
                                     if r["tree"] == label]
                             for label in ("other", "this")}
                         for k in runs[0]["rows"]})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
