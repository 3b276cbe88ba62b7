#!/usr/bin/env python3
"""Drive the PyTorch port's mining paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (sm_90a)
and ``nvcc``.  It imports nothing of JAX or of the reference package.

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   reports the build time and each kernel's registers.
2. Holds every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: assignment at n = 2^20, d = 32, k = 64
   (indices exact, distances within 2e-4); the fused masked Lloyd step at
   the same shape with the last 25% of rows masked, and at k = 1024,
   n = 65536 (indices equal to the plain version's and to the assignment
   kernel's, counts exact, sums and inertia within 1e-4 relative, two
   launches bitwise equal); eps-degree and expansion at n = 65536, d = 4,
   eps = 2 with a ~5% frontier (exact; a differing degree must be explained
   by a pair within 1e-5 * eps^2 of the boundary in float64).  Times
   kernel, plain version and a composed PyTorch yardstick (``library_ms``,
   never called by the port).
3. Slice 1's path, the one-job app, at full width through
   ``run_mining_job``: K-Means on 1,048,576 points of 32 features with 64
   clusters, and DBSCAN on 65,536 points of 4 features, each against its
   plain run (DBSCAN labels equal, K-Means step-1 assignment equal and
   final inertia within 1e-4 relative).
3b. Slice 2's path, the clustering service's kernel lane, through
   ``serve_mine.build_workload`` + ``drive`` on a
   ``ClusteringService(device="cuda")`` pinned to ``cuda-kernel``: 8
   K-Means requests of ~2^20 points (32 features, 64 clusters of
   15,360-16,384 points, so items pad and mask) and 8 DBSCAN requests of up
   to 16,384 points (4 features, 8 clusters), max_batch 4, continuous
   batching, the K-Means bucket warmed at start.  Every request resolves on
   ``cuda-kernel``; DBSCAN labels equal the plain ``dbscan.fit`` on the
   card; K-Means final inertia matches the same requests on ``torch-ref``
   within 1e-4 relative, and both lanes' cached steps give the same step-1
   assignment on a padded item.
4. Checks small runs against the sequential DBSCAN oracle, that a
   cancelled job ends SUSPENDED, and (4b) that a service batch preempted
   mid-run on the card ends SUSPENDED and resumes in a fresh service to the
   uninterrupted labels.
5. Launch counters are zeroed just before each path and read just after;
   every kernel of a path must have launched in it.  Prints one ``kernels``
   JSON line and, last, the device line.  Any failed check exits non-zero
   before that line.
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
FUSED_MASKED_FRACTION = 0.25
FUSED_LARGE_K = dict(n=65536, k=1024)
SEED = 0
# Where every phase runs: the card.
DEV = "cuda"

# The service phase: the paper's widest DBSCAN tuple, and K-Means items of
# about 2^20 points each, unequal so the bucket pads and masks rows.
SVC_KMEANS = dict(features=32, clusters=64, points=16384, min_points=15360)
SVC_DBSCAN = dict(features=4, clusters=8, points=2048, min_points=1792)
SVC_REQUESTS = 8
SVC_MAX_BATCH = 4
# The preemption phase: a K-Means batch that runs its full iteration count
# (tol 0), long enough to be cancelled mid-run.
PREEMPT_KMEANS = dict(features=32, clusters=64, points=4096)
PREEMPT_ITERS = 1000


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
    for name in ("distance", "fused", "neighbor"):
        regs = sorted({ln.split(":", 1)[1].strip()
                       for ln in build_mod.build_log(name).splitlines()
                       if "registers" in ln})
        log(f"ptxas {name}: {regs}")


def kernel_assign(torch, mods) -> dict:
    dops, dref, synth = mods["dops"], mods["dref"], mods["synth"]
    spec = spec_of(synth, ASSIGN_SHAPE)
    x, _, _ = synth.make_blobs(SEED, spec, device=DEV)
    g = torch.Generator().manual_seed(SEED)
    c = x[torch.randperm(x.shape[0], generator=g)[:spec.clusters].to(DEV)]
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


def _member_abs_sums(torch, x, idx, mask, k):
    """Per centroid and feature, the sum of |x| over its unmasked members."""
    out = torch.zeros((k, x.shape[1]), device=x.device)
    cols = torch.arange(k, device=x.device)
    for r in range(0, x.shape[0], 1 << 18):
        oh = ((idx[r:r + (1 << 18), None] == cols[None, :])
              & mask[r:r + (1 << 18), None]).float()
        out += oh.T @ x[r:r + (1 << 18)].abs()
    return out


def kernel_fused(torch, mods) -> dict:
    fops, dops, dref, synth = (mods["fops"], mods["dops"], mods["dref"],
                               mods["synth"])
    spec = spec_of(synth, ASSIGN_SHAPE)
    x, _, _ = synth.make_blobs(SEED, spec, device=DEV)
    g = torch.Generator().manual_seed(SEED + 2)
    n, d = x.shape
    k = spec.clusters
    c = x[torch.randperm(n, generator=g)[:k].to(DEV)].contiguous()
    mask = (torch.arange(n) < int(n * (1 - FUSED_MASKED_FRACTION))).to(DEV)

    def compare(x, c, mask, what) -> float:
        idx, sums, counts, inert = fops.fused_masked_assign_update(x, c, mask)
        ridx, rsums, rcounts, rinert = dref.fused_masked_assign_update_ref(
            x, c, mask)
        aidx, _ = dops.assign_clusters(x, c, with_dists=False)
        again = fops.fused_masked_assign_update(x, c, mask)
        torch.cuda.synchronize()
        check(bool(torch.equal(idx, ridx)),
              f"fused {what}: {int((idx != ridx).sum())} indices differ "
              f"from the plain version")
        check(bool(torch.equal(idx, aidx)),
              f"fused {what}: indices differ from assign_clusters")
        check(bool(torch.equal(counts, rcounts)),
              f"fused {what}: counts differ from the plain version")
        check(int(counts.sum()) == int(mask.sum()),
              f"fused {what}: counts sum to {int(counts.sum())}")
        # rtol 1e-4 against the scale of each sum: the summed magnitudes of
        # the cluster's members (a coordinate sum that cancels to near 0
        # keeps no relative precision in fp32, in any summation order)
        scale = _member_abs_sums(torch, x, ridx, mask, c.shape[0])
        check(bool(((sums - rsums).abs() <= 1e-4 * scale + 1e-6).all()),
              f"fused {what}: sums differ by up to "
              f"{float((sums - rsums).abs().max())}")
        check(bool(torch.allclose(inert, rinert, rtol=1e-4, atol=0.0)),
              f"fused {what}: inertia {float(inert)} vs {float(rinert)}")
        check(all(bool(torch.equal(a, b)) for a, b in
                  zip((idx, sums, counts, inert), again)),
              f"fused {what}: two launches differ (not deterministic)")
        err = max(float((sums - rsums).abs().max()),
                  float((inert - rinert).abs()))
        log(f"fused {what}: indices equal to plain and assign_clusters, "
            f"counts exact, max |dsums| {float((sums - rsums).abs().max())!r}"
            f", inertia {float(inert)!r} vs {float(rinert)!r}, "
            f"two launches bitwise equal")
        return err

    err = compare(x, c, mask, f"n={n} d={d} k={k}")
    nl, kl = FUSED_LARGE_K["n"], FUSED_LARGE_K["k"]
    xl = x[:nl].contiguous()
    cl = x[torch.randperm(n, generator=g)[:kl].to(DEV)].contiguous()
    ml = (torch.arange(nl) < int(nl * (1 - FUSED_MASKED_FRACTION))).to(DEV)
    compare(xl, cl, ml, f"n={nl} d={d} k={kl}")

    ms = time_ms(torch, lambda: fops.fused_masked_assign_update(x, c, mask),
                 reps=20)
    plain = time_ms(
        torch, lambda: dref.fused_masked_assign_update_ref(x, c, mask), reps=3)
    w = mask.float()

    def composed():
        # a yardstick of stock PyTorch calls, never called by the port
        a = torch.cdist(x, c).argmin(1)
        onehot = (a[:, None] == torch.arange(k, device=x.device)).float()
        onehot *= w[:, None]
        return onehot.T @ x, onehot.sum(0)

    lib = time_ms(torch, composed, reps=10)
    b, by = bound(n * d * 4 + 5 * n + 8 * k * d + 4 * k + 4, 2.0 * n * k * d)
    return dict(name="fused_masked_assign_update", route="cuda",
                source="src/repro_torch/csrc/fused.cu",
                replaces="src/repro/kernels/distance/fused.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib,
                shape=f"n={n} d={d} k={k} masked={FUSED_MASKED_FRACTION}",
                library_call="cdist(x, c).argmin(1) + masked one-hot "
                             "matmul (composed)",
                launch_shape=list(fops.launch_shape(n, k, d)))


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
    x, _, _ = synth.make_blobs(SEED, spec, device=DEV)
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
    front = (torch.rand(n, generator=g) < FRONTIER_FRACTION).to(DEV)
    reach = nops.expand_frontier(x, front, eps)
    rreach = nref.expand_frontier_ref(x, front, eps)
    torch.cuda.synchronize()
    mism = int((reach != rreach).sum())
    check(mism == 0, f"expansion: {mism} rows differ from the plain version")
    nf = int(front.sum())

    eps_t = torch.tensor(float(eps), device=DEV)

    def composed_degree():
        # cdist + threshold + row count, chunked (yardstick, never used)
        return torch.cat([(torch.cdist(x[r:r + 2048], x) <= eps_t).sum(1)
                          for r in range(0, n, 2048)])

    xf = x[front]

    def composed_expand():
        return torch.cat([(torch.cdist(x[r:r + 8192], xf) <= eps_t).any(1)
                          for r in range(0, n, 8192)])

    deg_ms = time_ms(torch, lambda: nops.epsilon_degree(x, eps), reps=10)
    deg_plain = time_ms(torch, lambda: nref.epsilon_degree_ref(x, eps), reps=1)
    exp_ms = time_ms(torch, lambda: nops.expand_frontier(x, front, eps),
                     reps=20)
    exp_plain = time_ms(torch, lambda: nref.expand_frontier_ref(x, front, eps),
                        reps=2)
    deg_lib = time_ms(torch, composed_degree, reps=3)
    exp_lib = time_ms(torch, composed_expand, reps=5)
    # 3*d fp32 operations per pair (subtract, multiply, add)
    deg_b, deg_by = bound(n * d * 4 + n * 4, 3.0 * d * n * n)
    exp_b, exp_by = bound(n * d * 4 + n + n, 3.0 * d * n * nf)
    common = dict(route="cuda", source="src/repro_torch/csrc/neighbor.cu",
                  library_call="cdist + threshold + reduction, chunked "
                               "(composed)")
    return [
        dict(name="epsilon_degree",
             replaces="src/repro/kernels/neighbor/neighbor.py:53",
             max_abs_err=deg_err, ms=deg_ms, plain_ms=deg_plain,
             bound_ms=deg_b, bound_by=deg_by, library_ms=deg_lib,
             shape=f"n={n} d={d} eps={eps}",
             **common),
        dict(name="expand_frontier",
             replaces="src/repro/kernels/neighbor/neighbor.py:65",
             max_abs_err=float(mism), ms=exp_ms, plain_ms=exp_plain,
             bound_ms=exp_b, bound_by=exp_by, library_ms=exp_lib,
             shape=f"n={n} d={d} eps={eps} frontier={nf}", **common),
    ]


def workdir(mods, prefix: str) -> str:
    """A new directory under the run's scratch root, removed at exit."""
    return tempfile.mkdtemp(prefix=prefix, dir=mods["tmp"])


def reset(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def main_path(torch, mods, counters) -> dict:
    mine, kmeans, dbscan, synth = (mods["mine"], mods["kmeans"],
                                   mods["dbscan"], mods["synth"])
    launches = {}
    work = workdir(mods, "mine_")

    # --- K-Means at full width -------------------------------------------
    reset(counters)
    km = mine.run_mining_job(algo="kmeans", workdir=work, device=DEV,
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
    km_plain = mine.run_mining_job(algo="kmeans", workdir=work, device=DEV,
                                   seed=SEED, use_kernel=False, **ASSIGN_SHAPE)
    check(counters["assign_clusters"].launches == 0,
          "plain kmeans job launched the kernel")
    rel = abs(km["inertia"] - km_plain["inertia"]) / abs(km_plain["inertia"])
    check(rel <= 1e-4, f"kmeans inertia {km['inertia']} vs plain "
                       f"{km_plain['inertia']} (rel {rel})")
    log(f"kmeans plain: wall {km_plain['wall_s']:.3f} s, "
        f"{km_plain['iterations']} iterations, inertia rel diff {rel!r}")
    x, _, _ = synth.make_blobs(SEED, spec_of(synth, ASSIGN_SHAPE),
                               device=DEV)
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
    db = mine.run_mining_job(algo="dbscan", workdir=work, device=DEV,
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
    db_plain = mine.run_mining_job(algo="dbscan", workdir=work, device=DEV,
                                   seed=SEED, use_kernel=False, **DBSCAN_SHAPE)
    check(counters["epsilon_degree"].launches == 0
          and counters["expand_frontier"].launches == 0,
          "plain dbscan job launched a kernel")
    check(bool(torch.equal(db["labels"], db_plain["labels"])),
          "dbscan labels differ from the plain run")
    log(f"dbscan plain: wall {db_plain['wall_s']:.3f} s, labels equal")
    x, _, _ = synth.make_blobs(SEED, spec_of(synth, DBSCAN_SHAPE),
                               device=DEV)
    dcfg = dbscan.DBSCANConfig.paper_defaults(DBSCAN_SHAPE["features"])
    wall = timed_wall(torch, lambda: dbscan.fit(x, dcfg))
    log(f"dbscan core fit (no job store): wall {wall:.3f} s")
    return launches


def _svc_workload(serve_mine, algo, shape, seed):
    return serve_mine.build_workload(
        SVC_REQUESTS, 4, algo, features=shape["features"],
        clusters=shape["clusters"], points=shape["points"],
        min_points=shape["min_points"], seed=seed)


def _svc(mods, work, **kw):
    return mods["service"].ClusteringService(
        work, device=DEV, max_batch=SVC_MAX_BATCH, continuous=True,
        bucket_policy="pow2", **kw)


def _drive(mods, svc, workload, executor) -> tuple:
    serve_mine = mods["serve_mine"]
    client = serve_mine.MiningClient(service=svc)
    results: list = []
    t0 = time.time()
    failures = serve_mine.drive(client, workload, rate=0, executor=executor,
                                timeout=900, results=results)
    wall = time.time() - t0
    check(failures == {"suspended": 0, "dropped": 0, "rejected": 0},
          f"service on {executor}: failures {failures}")
    check(all(r is not None and r["executor"] == executor for r in results),
          f"service: a request did not resolve on {executor}")
    return results, wall


def _report_service(label, svc, wall, results) -> dict:
    snap = svc.metrics_snapshot()
    lanes = snap["by_executor"]
    log(f"service {label}: {len(results)} requests in {wall:.3f} s wall, "
        f"p50 {snap['p50_latency_s'] * 1e3:.1f} ms / p99 "
        f"{snap['p99_latency_s'] * 1e3:.1f} ms, batches {snap['batches']}, "
        f"joins {snap['continuous']['joins']}, "
        f"lanes " + json.dumps({
            n: {k: st[k] for k in ("batches", "requests", "exec_s", "host_s",
                                   "device_s")} for n, st in lanes.items()}))
    return snap


def service_path(torch, mods, counters) -> dict:
    """Slice 2's main path: the service's kernel lane at full width."""
    serve_mine, kmeans, dbscan = (mods["serve_mine"], mods["kmeans"],
                                  mods["dbscan"])
    cuda, ref = "cuda-kernel", "torch-ref"
    t0 = time.time()
    km_work = _svc_workload(serve_mine, "kmeans", SVC_KMEANS, SEED)
    db_work = _svc_workload(serve_mine, "dbscan", SVC_DBSCAN, SEED + 1)
    log(f"service workload built in {time.time() - t0:.2f} s: K-Means sizes "
        f"{[w[2].shape[0] for w in km_work]}, DBSCAN sizes "
        f"{[w[2].shape[0] for w in db_work]}")
    d = SVC_KMEANS["features"]
    n_max = max(w[2].shape[0] for w in km_work)
    warm = [{"algo": "kmeans", "features": d, "n": n_max,
             "k": SVC_KMEANS["clusters"], "max_iters": 50,
             "executor": cuda}]
    svc = _svc(mods, workdir(mods, "svc_"),
               warm_start=warm)
    t0 = time.time()
    svc.start()
    log(f"service start (warm-up of the K-Means bucket): "
        f"{time.time() - t0:.3f} s, exec cache {svc.exec_cache.stats()}")
    launches = {}
    try:
        cache0 = svc.exec_cache.stats()
        reset(counters)
        km_res, km_wall = _drive(mods, svc, km_work, cuda)
        db_res, db_wall = _drive(mods, svc, db_work, cuda)
        for name in ("fused_masked_assign_update", "epsilon_degree",
                     "expand_frontier", "assign_clusters"):
            launches[name] = counters[name].launches
        cache1 = svc.exec_cache.stats()
    finally:
        svc.stop()   # joins the lanes: every batch is recorded after this
    snap = _report_service("kernel lane", svc, km_wall + db_wall,
                           km_res + db_res)
    iters = [r["iterations"] for r in km_res]
    check(set(snap["by_executor"]) == {cuda},
          f"service batches ran on {sorted(snap['by_executor'])}")
    check(launches["fused_masked_assign_update"] >= sum(iters) >= 1,
          f"service: {launches['fused_masked_assign_update']} fused launches "
          f"for {sum(iters)} K-Means iterations")
    check(launches["epsilon_degree"] == len(db_work),
          f"service: {launches['epsilon_degree']} degree launches for "
          f"{len(db_work)} DBSCAN items")
    check(launches["expand_frontier"] >= 1, "service: no expansion launch")
    check(launches["assign_clusters"] == 0,
          "service: the kernel lane launched the unfused assignment")
    check(cache1["warmed"] >= 1 and cache1["misses"] == cache0["misses"],
          f"exec cache: warmed {cache1['warmed']}, misses "
          f"{cache0['misses']} -> {cache1['misses']}")
    log(f"service launches {launches}; K-Means iterations {iters}; "
        f"exec cache {cache1}; K-Means wall {km_wall:.3f} s, "
        f"DBSCAN wall {db_wall:.3f} s")

    # DBSCAN: the plain run on the card, request by request
    for (_t, _a, x, params), r in zip(db_work, db_res):
        cfg = dbscan.DBSCANConfig(eps=params["eps"], min_pts=params["min_pts"],
                                  use_kernel=False)
        plain = dbscan.fit(torch.from_numpy(x).to(DEV), cfg)
        check(bool((plain.labels.cpu().numpy() == r["labels"]).all()),
              "service DBSCAN labels differ from the plain run on the card")
    log(f"service DBSCAN: labels of all {len(db_res)} requests equal the "
        f"plain run; clusters {[r['n_clusters'] for r in db_res]}")

    # K-Means: the same requests pinned to the plain lane
    svc_ref = _svc(mods, workdir(mods, "ref_"))
    svc_ref.start()
    try:
        ref_res, ref_wall = _drive(mods, svc_ref, km_work, ref)
    finally:
        svc_ref.stop()
    _report_service("torch-ref lane", svc_ref, ref_wall, ref_res)
    rels = []
    for r, p in zip(km_res, ref_res):
        rel = abs(r["inertia"] - p["inertia"]) / abs(p["inertia"])
        rels.append(rel)
        check(rel <= 1e-4,
              f"service K-Means: {r['iterations']} iterations inertia "
              f"{r['inertia']} vs torch-ref {p['iterations']} / "
              f"{p['inertia']} (rel {rel})")
    log(f"service K-Means vs torch-ref: inertia rel diff max {max(rels)!r}"
        f", iterations {iters} vs {[p['iterations'] for p in ref_res]}")

    # both lanes' cached steps from the same centroids on one padded item
    _t, _a, x, params = km_work[0]
    n_pad = 1 << (n_max - 1).bit_length()
    xp = torch.zeros((n_pad, d), device=DEV)
    xp[: x.shape[0]] = torch.from_numpy(x).to(DEV)
    mask = torch.arange(n_pad, device=DEV) < x.shape[0]
    cfg_k = kmeans.KMeansConfig(k=params["k"], max_iters=50)
    cfg_p = kmeans.KMeansConfig(k=params["k"], max_iters=50, use_kernel=False)
    c0 = kmeans.init_centroids(params["seed"], xp[: x.shape[0]], cfg_k)
    a_k = svc.exec_cache.kmeans_step(n_pad, d, cfg_k, DEV)(xp, c0, mask)[0]
    a_p = svc.exec_cache.kmeans_step(n_pad, d, cfg_p, DEV)(xp, c0, mask)[0]
    check(bool(torch.equal(a_k, a_p)),
          "service: cuda-kernel and torch-ref step-1 assignments differ")
    log(f"service step 1 on a padded item (n={x.shape[0]} of {n_pad}): "
        f"cuda-kernel and torch-ref assignments equal")
    # the Lloyd loop's iteration as the lane runs it: step + the shift read
    # that decides the stop rule (one host sync per iteration)
    step = svc.exec_cache.kmeans_step(n_pad, d, cfg_k, DEV)
    c, reps = c0, 20

    def loop():
        nonlocal c
        for _ in range(reps):
            _a, c, shift, _i = step(xp, c, mask)
            float(shift)

    per_iter = timed_wall(torch, loop) / reps * 1e3
    kernel = time_ms(
        torch, lambda: mods["fops"].fused_masked_assign_update(xp, c0, mask),
        reps=reps)
    log(f"service Lloyd iteration on the card: {per_iter:.3f} ms per "
        f"iteration (host clock, step + shift sync) against the fused "
        f"kernel's {kernel:.3f} ms (CUDA events)")
    return launches


def service_preemption(mods) -> None:
    """4b: a service batch cancelled mid-run on the card resumes in a fresh
    service over the same workdir to the uninterrupted labels."""
    serve_mine, service = mods["serve_mine"], mods["service"]
    shape = PREEMPT_KMEANS
    work = serve_mine.build_workload(
        2, 2, "kmeans", features=shape["features"],
        clusters=shape["clusters"], points=shape["points"], seed=SEED + 3)
    for w in work:
        w[3]["max_iters"] = PREEMPT_ITERS
        w[3]["tol"] = 0.0   # never converges: runs every iteration
    # both requests form one batch: max_batch is reached before max_wait
    kw = dict(device=DEV, max_batch=2, max_wait_s=10.0, continuous=True,
              bucket_policy="pow2", checkpoint_every=4)
    ref_svc = service.ClusteringService(
        workdir(mods, "pre_ref_"), **kw).start()
    try:
        ref, _ = _drive(mods, ref_svc, work, "cuda-kernel")
    finally:
        ref_svc.stop()
    work_pre = workdir(mods, "pre_")
    svc = service.ClusteringService(work_pre, **kw).start()
    client = serve_mine.MiningClient(service=svc)
    handles = [client.submit(t, a, x, params=p, executor="cuda-kernel")
               for t, a, x, p in work]
    deadline = time.time() + 120
    job_id = None
    while time.time() < deadline:
        job_id = handles[0].job_id
        if job_id is not None:
            job = svc.executor.jobs.get(job_id)
            if job is not None and (job.step or 0) >= 1:
                break   # a checkpoint past step 0 exists: mid-run
        time.sleep(0.005)
    svc.stop(preempt=True)
    check(job_id is not None, "preemption: no batch job formed")
    state = svc.executor.jobs.get(job_id).state
    check(str(getattr(state, "value", state)) == "SUSPENDED",
          f"preemption: job {job_id} ended {state}, not SUSPENDED")
    svc2 = service.ClusteringService(work_pre, **kw)
    outcomes = svc2.resume_suspended()
    svc2.stop()
    check(len(outcomes) == 1 and not outcomes[0].suspended
          and outcomes[0].resumed, f"preemption: resume gave {outcomes}")
    by_id = dict(zip(outcomes[0].request_ids, outcomes[0].results))
    check(sorted(by_id) == sorted(h.request_id for h in handles),
          f"preemption: the suspended job held requests {sorted(by_id)}")
    got = [by_id[h.request_id] for h in handles]
    for r, p in zip(got, ref):
        check(bool((r["labels"] == p["labels"]).all())
              and r["iterations"] == p["iterations"] == PREEMPT_ITERS,
              "preemption: resumed labels differ from the uninterrupted run")
    log(f"preemption: service job {job_id} SUSPENDED mid-run on the card, "
        f"resumed in a fresh service to the uninterrupted labels "
        f"({PREEMPT_ITERS} iterations, resume {outcomes[0].exec_s:.3f} s)")


def small_checks(torch, mods) -> None:
    mine, dbscan, synth, cancel = (mods["mine"], mods["dbscan"], mods["synth"],
                                   mods["cancel"])
    x, _, _ = synth.make_blobs(3, synth.ClusterSpec(2, 6, 256), device=DEV)
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
                              workdir=workdir(mods, "cancel_"),
                              token=tok, device=DEV)
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
    from repro_torch.kernels.distance import fused as fops
    from repro_torch.kernels.distance import ops as dops, ref as dref
    from repro_torch.kernels.neighbor import ops as nops, ref as nref
    from repro_torch.launch import mine, serve_mine
    from repro_torch.runtime import backend
    from repro_torch import service

    mods = dict(dops=dops, dref=dref, fops=fops, nops=nops, nref=nref,
                synth=synth, mine=mine, kmeans=kmeans, dbscan=dbscan,
                cancel=cancel, serve_mine=serve_mine, service=service)
    counters = {"assign_clusters": dops.assign_clusters,
                "fused_masked_assign_update": fops.fused_masked_assign_update,
                "epsilon_degree": nops.epsilon_degree,
                "expand_frontier": nops.expand_frontier}
    t_start = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    backend.load("cuda")  # fp32 matmul at "highest", no TF32
    # every job store, WAL and checkpoint of the run lives under one
    # scratch root (in TMPDIR), removed however the run ends
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     ignore_cleanup_errors=True) as tmp:
        mods["tmp"] = tmp
        try:
            build(_build)
            rows = [kernel_assign(torch, mods), kernel_fused(torch, mods),
                    *kernel_neighbor(torch, mods)]
            t_path = time.time()
            mine_launches = main_path(torch, mods, counters)
            log(f"one-job path: {time.time() - t_path:.1f} s, launches "
                f"{mine_launches}")
            t_path = time.time()
            svc_launches = service_path(torch, mods, counters)
            log(f"service path: {time.time() - t_path:.1f} s, launches "
                f"{svc_launches}")
            t_path = time.time()
            service_preemption(mods)
            small_checks(torch, mods)
            log(f"preemption + small checks: {time.time() - t_path:.1f} s")
        except SmokeFailure as exc:
            print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
            return 1
    # launches: from the newest path that runs the kernel (the assignment
    # kernel only runs on the one-job path)
    launches = dict(mine_launches)
    launches.update({k: v for k, v in svc_launches.items()
                     if k != "assign_clusters"})
    for row in rows:
        row["launches"] = launches[row["name"]]
        log(json.dumps({"kernel": row["name"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "launches": row["launches"],
                        "launches_one_job_path": mine_launches.get(
                            row["name"]),
                        "launches_service_path": svc_launches.get(
                            row["name"]),
                        "max_err": row["max_abs_err"],
                        "library_ms": row["library_ms"],
                        "library_call": row.get("library_call"),
                        "kernel_only_ms": row.get("kernel_only_ms"),
                        "launch_shape": row.get("launch_shape"),
                        "shape": row["shape"], "card": card}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total: {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    # the smoke runs on one card, whatever the machine holds
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
