#!/usr/bin/env python3
"""Drive the PyTorch port's mining path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``.  It imports nothing of JAX or of the reference package.

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   reports the build time and each kernel's registers.
2. Holds every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: assignment at n = 2^20, d = 32, k = 64
   (indices exact, distances within 2e-4); eps-degree and expansion at
   n = 65536, d = 4, eps = 2 with a ~5% frontier (exact; a differing degree
   must be explained by a pair within 1e-5 * eps^2 of the boundary in
   float64).  Times kernel, plain version and, for assignment,
   ``torch.cdist(x, c).argmin(1)`` as a yardstick.
3. Runs the main path at full width through ``run_mining_job``: K-Means on
   1,048,576 points of 32 features with 64 clusters, and DBSCAN on 65,536
   points of 4 features.  The launch counters are zeroed just before each
   job and read just after; every kernel of the job must have launched.
   Each job is repeated with the plain versions (``use_kernel=False``) and
   must agree: DBSCAN labels equal, K-Means step-1 assignment equal and
   final inertia within 1e-4 relative.
4. Checks small runs against the sequential DBSCAN oracle and that a
   cancelled job ends SUSPENDED.
5. Prints one ``kernels`` JSON line and, last, the device line.  Any failed
   check exits non-zero before that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12      # FLOP/s
PEAK_BYTES = 3.35e12   # byte/s

ASSIGN_SHAPE = dict(features=32, clusters=64, size=16384)   # n = 2^20
DBSCAN_SHAPE = dict(features=4, clusters=8, size=8192)      # n = 65536
FRONTIER_FRACTION = 0.05
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_wall(torch, fn) -> float:
    """Host wall seconds of ``fn`` up to a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def spec_of(synth, shape: dict):
    return synth.ClusterSpec(shape["features"], shape["clusters"],
                             shape["size"])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build(build_mod) -> None:
    t0 = time.time()
    build_mod.build_all()
    log(f"build: {time.time() - t0:.2f} s")
    for name in ("distance", "neighbor"):
        regs = sorted({ln.split(":", 1)[1].strip()
                       for ln in build_mod.build_log(name).splitlines()
                       if "registers" in ln})
        log(f"ptxas {name}: {regs}")


def kernel_assign(torch, mods) -> dict:
    dops, dref, synth = mods["dops"], mods["dref"], mods["synth"]
    spec = spec_of(synth, ASSIGN_SHAPE)
    x, _, _ = synth.make_blobs(SEED, spec, device="cuda")
    g = torch.Generator().manual_seed(SEED)
    c = x[torch.randperm(x.shape[0], generator=g)[:spec.clusters].cuda()]
    n, d = x.shape
    k = c.shape[0]
    idx, dist = dops.assign_clusters(x, c)
    ridx, rdist = dref.assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    mism = int((idx != ridx).sum())
    err = float((dist - rdist).abs().max())
    check(mism == 0, f"assignment: {mism} indices differ from the plain version")
    check(bool(torch.allclose(dist, rdist, rtol=2e-4, atol=2e-4)),
          f"assignment: distances differ by up to {err}")
    ms = time_ms(torch, lambda: dops.assign_clusters(x, c), reps=20)
    kernel_only = time_ms(
        torch, lambda: dops.assign_clusters(x, c, with_dists=False), reps=20)
    plain = time_ms(torch, lambda: dref.assign_clusters_ref(x, c), reps=3)
    lib = time_ms(torch, lambda: torch.cdist(x, c).argmin(1), reps=20)
    b, by = bound(n * d * 4 + k * d * 4 + n * 8, 2.0 * n * k * d)
    return dict(name="assign_clusters", route="cuda",
                source="src/repro_torch/csrc/distance.cu",
                replaces="src/repro/kernels/distance/distance.py:46",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib,
                shape=f"n={n} d={d} k={k}", kernel_only_ms=kernel_only)


def explained_degree_diffs(torch, x, deg_k, deg_p, eps) -> int:
    """Count differing points; fail unless every one is explained by pairs
    within 1e-5 * eps^2 of the boundary (float64)."""
    rows = torch.nonzero(deg_k != deg_p).flatten().tolist()
    x64 = x.double()
    e2 = float(eps) ** 2
    for i in rows:
        d2 = ((x64 - x64[i]) ** 2).sum(1)
        near = int(((d2 - e2).abs() <= 1e-5 * e2).sum())
        diff = abs(int(deg_k[i]) - int(deg_p[i]))
        check(diff <= near, f"degree of point {i} differs by {diff} with only "
                            f"{near} pairs near the eps boundary")
    return len(rows)


def kernel_neighbor(torch, mods) -> list:
    nops, nref, synth = mods["nops"], mods["nref"], mods["synth"]
    spec = spec_of(synth, DBSCAN_SHAPE)
    x, _, _ = synth.make_blobs(SEED, spec, device="cuda")
    n, d = x.shape
    eps = spec.dbscan_eps
    deg = nops.epsilon_degree(x, eps)
    rdeg = nref.epsilon_degree_ref(x, eps)
    torch.cuda.synchronize()
    n_diff = explained_degree_diffs(torch, x, deg, rdeg, eps)
    log(f"degree: {n_diff} points differ from the plain version, each "
        f"explained by pairs at the eps boundary")
    deg_err = float((deg - rdeg).abs().max())
    g = torch.Generator().manual_seed(SEED + 1)
    front = (torch.rand(n, generator=g) < FRONTIER_FRACTION).cuda()
    reach = nops.expand_frontier(x, front, eps)
    rreach = nref.expand_frontier_ref(x, front, eps)
    torch.cuda.synchronize()
    mism = int((reach != rreach).sum())
    check(mism == 0, f"expansion: {mism} rows differ from the plain version")
    nf = int(front.sum())

    deg_ms = time_ms(torch, lambda: nops.epsilon_degree(x, eps), reps=10)
    deg_plain = time_ms(torch, lambda: nref.epsilon_degree_ref(x, eps), reps=1)
    exp_ms = time_ms(torch, lambda: nops.expand_frontier(x, front, eps),
                     reps=20)
    exp_plain = time_ms(torch, lambda: nref.expand_frontier_ref(x, front, eps),
                        reps=2)
    # 3*d fp32 operations per pair (subtract, multiply, add)
    deg_b, deg_by = bound(n * d * 4 + n * 4, 3.0 * d * n * n)
    exp_b, exp_by = bound(n * d * 4 + n + n, 3.0 * d * n * nf)
    common = dict(route="cuda", source="src/repro_torch/csrc/neighbor.cu",
                  library_ms=None)
    return [
        dict(name="epsilon_degree",
             replaces="src/repro/kernels/neighbor/neighbor.py:53",
             max_abs_err=deg_err, ms=deg_ms, plain_ms=deg_plain,
             bound_ms=deg_b, bound_by=deg_by, shape=f"n={n} d={d} eps={eps}",
             **common),
        dict(name="expand_frontier",
             replaces="src/repro/kernels/neighbor/neighbor.py:65",
             max_abs_err=float(mism), ms=exp_ms, plain_ms=exp_plain,
             bound_ms=exp_b, bound_by=exp_by,
             shape=f"n={n} d={d} eps={eps} frontier={nf}", **common),
    ]


def reset(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def main_path(torch, mods, counters) -> dict:
    mine, kmeans, dbscan, synth = (mods["mine"], mods["kmeans"],
                                   mods["dbscan"], mods["synth"])
    launches = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_")

    # --- K-Means at full width -------------------------------------------
    reset(counters)
    km = mine.run_mining_job(algo="kmeans", workdir=work, device="cuda",
                             seed=SEED, **ASSIGN_SHAPE)
    launches["assign_clusters"] = counters["assign_clusters"].launches
    check(km["final_state"] == "SUCCEEDED", f"kmeans job: {km['final_state']}")
    check(launches["assign_clusters"] >= km["iterations"] >= 1,
          f"kmeans: {launches['assign_clusters']} assignment launches for "
          f"{km['iterations']} iterations")
    check(counters["epsilon_degree"].launches == 0
          and counters["expand_frontier"].launches == 0,
          "kmeans job launched DBSCAN kernels")
    log(f"kmeans: n={ASSIGN_SHAPE['clusters'] * ASSIGN_SHAPE['size']} "
        f"wall {km['wall_s']:.3f} s, {km['iterations']} iterations, "
        f"converged={km['converged']}, inertia {km['inertia']!r}, "
        f"assign launches {launches['assign_clusters']}")
    reset(counters)
    km_plain = mine.run_mining_job(algo="kmeans", workdir=work, device="cuda",
                                   seed=SEED, use_kernel=False, **ASSIGN_SHAPE)
    check(counters["assign_clusters"].launches == 0,
          "plain kmeans job launched the kernel")
    rel = abs(km["inertia"] - km_plain["inertia"]) / abs(km_plain["inertia"])
    check(rel <= 1e-4, f"kmeans inertia {km['inertia']} vs plain "
                       f"{km_plain['inertia']} (rel {rel})")
    log(f"kmeans plain: wall {km_plain['wall_s']:.3f} s, "
        f"{km_plain['iterations']} iterations, inertia rel diff {rel!r}")
    x, _, _ = synth.make_blobs(SEED, spec_of(synth, ASSIGN_SHAPE),
                               device="cuda")
    cfg = kmeans.KMeansConfig(k=ASSIGN_SHAPE["clusters"])
    c0 = kmeans.init_centroids(SEED, x, cfg)
    a_k = kmeans.kmeans_step(x, c0, cfg)[0]
    a_p = kmeans.kmeans_step(
        x, c0, kmeans.KMeansConfig(k=cfg.k, use_kernel=False))[0]
    check(bool((a_k == a_p).all()), "kmeans step-1 assignment differs "
                                    "from the plain run")
    check(km["labels"].shape == (x.shape[0],), "kmeans labels shape")
    wall = timed_wall(torch, lambda: kmeans.fit(SEED, x, cfg))
    log(f"kmeans core fit (no job store): wall {wall:.3f} s")

    # --- DBSCAN at full width --------------------------------------------
    reset(counters)
    db = mine.run_mining_job(algo="dbscan", workdir=work, device="cuda",
                             seed=SEED, **DBSCAN_SHAPE)
    launches["epsilon_degree"] = counters["epsilon_degree"].launches
    launches["expand_frontier"] = counters["expand_frontier"].launches
    check(db["final_state"] == "SUCCEEDED", f"dbscan job: {db['final_state']}")
    check(launches["epsilon_degree"] == 1,
          f"dbscan: {launches['epsilon_degree']} degree launches")
    check(launches["expand_frontier"] == db["expansions"] >= 1,
          f"dbscan: {launches['expand_frontier']} expansion launches for "
          f"{db['expansions']} expansions")
    check(counters["assign_clusters"].launches == 0,
          "dbscan job launched the assignment kernel")
    log(f"dbscan: n={DBSCAN_SHAPE['clusters'] * DBSCAN_SHAPE['size']} "
        f"wall {db['wall_s']:.3f} s, {db['expansions']} expansions, "
        f"{db['n_clusters']} clusters, {db['noise']} noise points")
    reset(counters)
    db_plain = mine.run_mining_job(algo="dbscan", workdir=work, device="cuda",
                                   seed=SEED, use_kernel=False, **DBSCAN_SHAPE)
    check(counters["epsilon_degree"].launches == 0
          and counters["expand_frontier"].launches == 0,
          "plain dbscan job launched a kernel")
    check(bool(torch.equal(db["labels"], db_plain["labels"])),
          "dbscan labels differ from the plain run")
    log(f"dbscan plain: wall {db_plain['wall_s']:.3f} s, labels equal")
    x, _, _ = synth.make_blobs(SEED, spec_of(synth, DBSCAN_SHAPE),
                               device="cuda")
    dcfg = dbscan.DBSCANConfig.paper_defaults(DBSCAN_SHAPE["features"])
    wall = timed_wall(torch, lambda: dbscan.fit(x, dcfg))
    log(f"dbscan core fit (no job store): wall {wall:.3f} s")
    return launches


def small_checks(torch, mods) -> None:
    mine, dbscan, synth, cancel = (mods["mine"], mods["dbscan"], mods["synth"],
                                   mods["cancel"])
    x, _, _ = synth.make_blobs(3, synth.ClusterSpec(2, 6, 256), device="cuda")
    cfg = dbscan.DBSCANConfig.paper_defaults(2)
    res = dbscan.fit(x, cfg)
    oracle = dbscan.fit_oracle(x.cpu().numpy(), cfg)
    check(bool((res.labels.cpu().numpy() == oracle).all()),
          "small dbscan on the card differs from the sequential oracle")
    log(f"oracle: small dbscan on the card equals the oracle "
        f"({int(res.n_clusters)} clusters)")
    tok = cancel.CancellationToken()
    tok.cancel()
    out = mine.run_mining_job(algo="kmeans", features=2, clusters=4, size=128,
                              workdir=tempfile.mkdtemp(prefix="chip_smoke_"),
                              token=tok, device="cuda")
    check(out["final_state"] == "SUSPENDED" and out["cancelled"],
          f"cancelled job ended {out['final_state']}")
    log("cancel: pre-cancelled job ended SUSPENDED")


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import dbscan, kmeans
    from repro_torch.core import cancellation as cancel
    from repro_torch.data import synthetic as synth
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance import ops as dops, ref as dref
    from repro_torch.kernels.neighbor import ops as nops, ref as nref
    from repro_torch.launch import mine
    from repro_torch.runtime import backend

    mods = dict(dops=dops, dref=dref, nops=nops, nref=nref, synth=synth,
                mine=mine, kmeans=kmeans, dbscan=dbscan, cancel=cancel)
    counters = {"assign_clusters": dops.assign_clusters,
                "epsilon_degree": nops.epsilon_degree,
                "expand_frontier": nops.expand_frontier}
    t_start = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    backend.load("cuda")  # fp32 matmul at "highest", no TF32
    try:
        build(_build)
        rows = [kernel_assign(torch, mods), *kernel_neighbor(torch, mods)]
        launches = main_path(torch, mods, counters)
        small_checks(torch, mods)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = launches[row["name"]]
        log(json.dumps({"kernel": row["name"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "launches": row["launches"],
                        "max_err": row["max_abs_err"],
                        "library_ms": row["library_ms"],
                        "kernel_only_ms": row.get("kernel_only_ms"),
                        "shape": row["shape"], "card": card}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total: {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
