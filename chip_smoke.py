#!/usr/bin/env python3
"""Drive the PyTorch port's mining and LM serving paths on one CUDA card and
check them.

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
   by a pair within 1e-5 * eps^2 of the boundary in float64); flash
   attention at OLMo-1B's prefill shape (B 4, S 4096, 16 heads of 128,
   bf16, causal), GLM4-9B's (B 1, S 4096, 32 heads on 2 KV heads) and
   MiniCPM-2B's width (B 2, S 2048, 36 heads of 64) and three more (odd
   length with GQA, full attention at D 96, a narrow head), within 2e-4
   (fp32) / 3e-2 (bf16) of the plain version elementwise and within
   1e-4 / 1e-2 of its norm in every 128-row query block of a head (against
   the plain version in fp32), two launches bitwise equal;
   every bf16 row must take the tensor-core route ("tc",
   ``csrc/flash_sm90.cu``) and every fp32 row the CUDA-core one ("simt",
   ``csrc/attention.cu``).  Times kernel, plain version and a PyTorch
   yardstick (``library_ms``, never called by the port; SDPA for
   attention), and the "simt" kernel on the OLMo-1B row's bf16 inputs
   beside the "tc" one, held to the same two bounds.  The build step logs
   the ``HGMMA``, ``HMMA`` and ``UTMALDG`` instructions in the SASS of the
   flash, assignment and fused libraries and fails without tensor-core
   instructions (``HGMMA`` for flash).  The assignment and fused kernels are
   also held to their plain versions at near-ties (points at the midpoints
   of centroid pairs and 1 ulp either side, duplicate centroids, points on
   centroids, an inf row and a NaN row) at d = 32 and d = 5: indices and
   scores bit for bit; at d = 96, 128, 192 and 1024 (either side of the
   switch to the wide search at d > 96), bit for bit, each timed with both
   search forms where they fit; and the exact rechecks per point (mean and
   most) are logged at every shape.
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
   assignment on a padded item.  Then one K-Means batch of new requests
   runs on a service of its own under ``torch.profiler``: its device time,
   the fused step's share of it, and the lane's exec_s - host_s for the
   batch are logged.
3c. Slice 3's path, LM serving, through ``serve.serve_batch`` at OLMo-1B's
   full width (16 layers, d_model 2048, vocab 50304, synthetic bf16
   weights): batch 4, prompt 4096, 32 generated tokens.  The flash kernel
   must launch once per layer of the prefill (16), every launch on the
   "tc" route, and never in decode, and every logit must be finite.  Then,
   in fp32 at the same widths (batch 2, prompt 1024, 8 tokens), the kernel
   route ("simt", as fp32 goes) against the same run with the layers'
   attention patched to the plain version: prefill logits within
   1e-4 of the largest logit, greedy tokens equal.  The bf16 run's distance
   from the plain route is printed, not gated.
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

import contextlib
import dataclasses
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
PEAK_BF16 = 989e12     # FLOP/s, dense tensor cores
PEAK_TF32 = 495e12     # FLOP/s, dense tensor cores
PEAK_BYTES = 3.35e12   # byte/s

ASSIGN_SHAPE = dict(features=32, clusters=64, size=16384)   # n = 2^20
DBSCAN_SHAPE = dict(features=4, clusters=8, size=8192)      # n = 65536
FRONTIER_FRACTION = 0.05
FUSED_MASKED_FRACTION = 0.25
FUSED_LARGE_K = dict(n=65536, k=1024)
# Both K-Means kernels either side of the plan's choice of search form
# (d > 96 is wide), and at a common embedding width: (n, k, d).
SEARCH_WIDTHS = [(65536, 64, 96), (65536, 64, 128), (65536, 64, 192),
                 (16384, 64, 1024)]
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

# Flash attention on the card: (what, B, S, H, KV, D, dtype, causal).  The
# first is OLMo-1B's prefill at the serving shape; the row's timing is there.
ATTN_SHAPES = [
    ("OLMo-1B prefill", 4, 4096, 16, 16, 128, "bfloat16", True),
    ("GLM4-9B prefill", 1, 4096, 32, 2, 128, "bfloat16", True),
    ("MiniCPM-2B width", 2, 2048, 36, 36, 64, "bfloat16", True),
    ("odd length, GQA", 2, 1000, 32, 2, 128, "float32", True),
    ("full attention", 1, 517, 12, 12, 96, "float32", False),
    ("narrow head", 2, 300, 8, 8, 64, "bfloat16", True),
]
# the reference's own flash-test tolerances (tests/test_parallel.py)
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# and per 128-row query block of one (b, h), the relative Frobenius error
# against the plain version in fp32 (ref.block_error): what the elementwise
# bound lets through at long rows, where outputs are ~0.03
ATTN_BLOCK_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# which kernel each dtype's rows must take (kernels/attention/ops._route)
ATTN_ROUTE = {"float32": "simt", "bfloat16": "tc"}
# The LM serving phase: OLMo-1B at full width, and the fp32 check's shape.
SERVE = dict(arch="olmo-1b", batch=4, prompt_len=4096, gen=32)
SERVE_CHECK = dict(batch=2, prompt_len=1024, gen=8)
SERVE_LOGIT_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound(bytes_moved: float, flops: float, peak: float = PEAK_FP32) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
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


# Tensor-core (wgmma: HGMMA, mma.sync: HMMA) and TMA instructions counted
# in each library's SASS, and those of which the build needs at least one.
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")
SASS_NEEDS = {"flash_sm90": ("HGMMA",), "distance": ("HGMMA", "HMMA"),
              "fused": ("HGMMA", "HMMA")}


def build(build_mod) -> dict:
    """Build every kernel; log registers and spills, and the tensor-core
    and TMA instruction counts of the libraries that use them (returned)."""
    t0 = time.time()
    build_mod.build_all()
    log(f"build: {time.time() - t0:.2f} s")
    for name in ("attention", "distance", "flash_sm90", "fused", "neighbor"):
        regs = sorted({ln.split(":", 1)[-1].strip()
                       for ln in build_mod.build_log(name).splitlines()
                       if "Used" in ln or "spill" in ln})
        log(f"ptxas {name}: {regs}")
    sass = {}
    for name, needs in SASS_NEEDS.items():
        out = subprocess.run(
            [build_mod.cuda_tool("cuobjdump"), "-sass",
             str(build_mod.library_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        sass[name] = {op: sum(ln.count(op) for ln in out.splitlines())
                      for op in SASS_OPS}
        log(f"SASS {name}: " + ", ".join(f"{v} {op}" for op, v in
                                         sass[name].items()) + " instructions")
        check(sum(sass[name][op] for op in needs) > 0,
              f"{name}: no {' or '.join(needs)} instruction in its SASS")
    return sass


def same_bits(torch, a, b) -> bool:
    """Equal bits, NaN matching NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32)))


def near_ties(torch, d: int, seed: int):
    """Points at the midpoints of centroid pairs and 1 ulp either side,
    duplicate centroids, points equal to a centroid, random points, a row
    holding inf and one holding NaN; and the centroids."""
    g = torch.Generator().manual_seed(seed)
    c = torch.randn(56, d, generator=g) * 3
    c = torch.cat([c, c[:8]])
    mid = (c[:28] + c[28:56]) / 2
    inf = torch.full_like(mid, float("inf"))
    bad = torch.randn(2, d, generator=g)
    bad[0, d // 2] = float("inf")
    bad[1, 0] = float("nan")
    x = torch.cat([mid, torch.nextafter(mid, inf), torch.nextafter(mid, -inf),
                   c, torch.randn(4000, d, generator=g) * 3, bad])
    return x.contiguous().to(DEV), c.contiguous().to(DEV)


def recheck_line(dops, fn, what, n) -> dict:
    total, most = dops.rechecks(fn)
    log(f"rechecks {what}: {total / n!r} per point (mean), {most} at most")
    return dict(mean=total / n, max=most)


def wide_rows(torch, mods) -> None:
    """Both K-Means kernels on each side of the plan's choice between the
    staged search (whole rows) and the wide one (d > ops.WIDE_D, the
    products streamed box by box), at SEARCH_WIDTHS: the assignment's
    indices and distances and the fused step's indices and counts equal to
    the plain version's bits, the fused sums within 1e-4 of their scale;
    each timed with the plan's search and with the other one where it fits
    (the staged search cannot hold rows of 1024 features)."""
    dops, fops, dref = mods["dops"], mods["fops"], mods["dref"]
    for n, k, d in SEARCH_WIDTHS:
        g = torch.Generator().manual_seed(SEED + d)
        c = torch.randn(k, d, generator=g) * 4
        x = c[torch.randint(0, k, (n,), generator=g)] + torch.randn(
            n, d, generator=g)
        x, c = x.to(DEV), c.to(DEV)
        mask = (torch.arange(n) % 4 != 1).to(DEV)
        p = dops.plan(n, k, d)
        idx, dist = dops.assign_clusters(x, c)
        ridx, rdist = dref.assign_clusters_ref(x, c)
        fidx, sums, counts, _ = fops.fused_masked_assign_update(x, c, mask)
        _, rsums, rcounts, _ = dref.fused_masked_assign_update_ref(x, c, mask)
        torch.cuda.synchronize()
        what = f"n={n} d={d} k={k} ({'wide' if p.wide else 'staged'})"
        check(bool(torch.equal(idx, ridx)) and same_bits(torch, dist, rdist),
              f"assignment {what}: differs from the plain version")
        scale = _member_abs_sums(torch, x, ridx, mask, k)
        check(bool(torch.equal(fidx, ridx))
              and bool(torch.equal(counts, rcounts))
              and bool(((sums - rsums).abs() <= 1e-4 * scale + 1e-6).all()),
              f"fused step {what}: differs from the plain version")
        times = {}
        wide_d = dops.WIDE_D
        for form, forced in (("staged", 1 << 30), ("wide", 0)):
            dops.WIDE_D = forced
            try:
                times[form] = (
                    time_ms(torch, lambda: dops.assign_clusters(x, c),
                            reps=10),
                    time_ms(torch, lambda: fops.fused_masked_assign_update(
                        x, c, mask), reps=10))
            except ValueError:  # no room in shared memory
                times[form] = None
            finally:
                dops.WIDE_D = wide_d
        log(f"search forms {what}: bit-identical to the plain version; "
            f"assignment / fused step ms: " + ", ".join(
                f"{form} " + ("does not fit" if t is None else
                              f"{t[0]:.4f} / {t[1]:.4f}")
                for form, t in times.items()))


def kernel_assign(torch, mods, sass: dict) -> dict:
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
    rechecks = recheck_line(dops, dops.assign_clusters,
                            f"assignment n={n} d={d} k={k}", n)
    mism = int((idx != ridx).sum())
    err = float((dist - rdist).abs().max())
    check(mism == 0, f"assignment: {mism} indices differ from the plain version")
    check(bool(torch.allclose(dist, rdist, rtol=2e-4, atol=2e-4)),
          f"assignment: distances differ by up to {err}")
    log(f"assignment n={n} d={d} k={k}: indices exact, distances "
        f"{'bit-identical' if same_bits(torch, dist, rdist) else 'differ'}"
        f" (max |diff| {err!r})")
    # near-ties, duplicates, points on centroids, inf and NaN rows: index
    # and score bits of the plain version, with and without distances
    for dt in (32, 5):
        xt, ct = near_ties(torch, dt, SEED + dt)
        for with_dists in (False, True):
            tidx, tout = dops.assign_clusters(xt, ct, with_dists=with_dists)
            tridx, trscore = dref.assign_scores_ref(xt, ct)
            trout = dref.add_point_norms(xt, trscore) if with_dists else trscore
            check(bool(torch.equal(tidx, tridx)) and same_bits(torch, tout,
                                                                trout),
                  f"assignment near-ties d={dt}: differs from the plain "
                  f"version (with_dists={with_dists})")
        recheck_line(dops, dops.assign_clusters,
                     f"assignment near-ties n={xt.shape[0]} d={dt} "
                     f"k={ct.shape[0]}", xt.shape[0])
    log("assignment near-ties (midpoints +-1 ulp, duplicate centroids, points "
        "on centroids, inf and NaN rows) at d=32 and d=5: bit-identical")
    ms = time_ms(torch, lambda: dops.assign_clusters(x, c), reps=20)
    kernel_only = time_ms(
        torch, lambda: dops.assign_clusters(x, c, with_dists=False), reps=20)
    plain = time_ms(torch, lambda: dref.assign_clusters_ref(x, c), reps=3)
    lib = time_ms(torch, lambda: torch.cdist(x, c).argmin(1), reps=20)
    # the scores as three TF32 products on the tensor cores; and the same
    # work's fp32 CUDA-core bound
    b, by = bound(n * d * 4 + k * d * 4 + n * 8, 3 * 2.0 * n * k * d,
                  PEAK_TF32)
    b32, _ = bound(n * d * 4 + k * d * 4 + n * 8, 2.0 * n * k * d)
    return dict(name="assign_clusters", route="cuda",
                source="src/repro_torch/csrc/distance.cu",
                replaces="src/repro/kernels/distance/distance.py:46",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib, bound_fp32_ms=b32,
                shape=f"n={n} d={d} k={k}", kernel_only_ms=kernel_only,
                rechecks=rechecks, sass=sass)


def _member_abs_sums(torch, x, idx, mask, k):
    """Per centroid and feature, the sum of |x| over its unmasked members."""
    out = torch.zeros((k, x.shape[1]), device=x.device)
    cols = torch.arange(k, device=x.device)
    for r in range(0, x.shape[0], 1 << 18):
        oh = ((idx[r:r + (1 << 18), None] == cols[None, :])
              & mask[r:r + (1 << 18), None]).float()
        out += oh.T @ x[r:r + (1 << 18)].abs()
    return out


def kernel_fused(torch, mods, sass: dict) -> dict:
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
        rechecks[what] = recheck_line(dops, fops.fused_masked_assign_update,
                                      f"fused {what}", x.shape[0])
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

    rechecks = {}
    err = compare(x, c, mask, f"n={n} d={d} k={k}")
    nl, kl = FUSED_LARGE_K["n"], FUSED_LARGE_K["k"]
    xl = x[:nl].contiguous()
    cl = x[torch.randperm(n, generator=g)[:kl].to(DEV)].contiguous()
    ml = (torch.arange(nl) < int(nl * (1 - FUSED_MASKED_FRACTION))).to(DEV)
    compare(xl, cl, ml, f"n={nl} d={d} k={kl}")
    # near-ties (as for the assignment): indices of the plain version and of
    # assign_clusters, counts exact; the plain version's one-hot product
    # turns a masked-out inf or NaN row into NaN sums (0 * inf), so its sums
    # are taken over the finite rows
    for dt in (32, 5):
        xt, ct = near_ties(torch, dt, SEED + dt)
        finite = torch.isfinite(xt).all(1)
        mt = finite & (torch.arange(xt.shape[0], device=DEV) % 5 != 0)
        tidx, tsums, tcounts, tinert = fops.fused_masked_assign_update(
            xt, ct, mt)
        tridx, _, trcounts, trinert = dref.fused_masked_assign_update_ref(
            xt, ct, mt)
        _, trsums, _, _ = dref.fused_masked_assign_update_ref(
            xt[finite], ct, mt[finite])
        taidx, _ = dops.assign_clusters(xt, ct)
        torch.cuda.synchronize()
        what = f"near-ties n={xt.shape[0]} d={dt} k={ct.shape[0]}"
        rechecks[what] = recheck_line(
            dops, fops.fused_masked_assign_update, f"fused {what}",
            xt.shape[0])
        check(bool(torch.equal(tidx, tridx)) and bool(torch.equal(tidx, taidx))
              and bool(torch.equal(tcounts, trcounts)),
              f"fused {what}: indices or counts differ from the plain version")
        tscale = _member_abs_sums(torch, xt[finite], tridx[finite], mt[finite],
                                  ct.shape[0])
        check(bool(((tsums - trsums).abs() <= 1e-4 * tscale + 1e-6).all())
              and bool(torch.allclose(tinert, trinert, rtol=1e-4, atol=0.0)),
              f"fused {what}: sums or inertia differ from the plain version")
    log("fused near-ties at d=32 and d=5: indices equal to plain and "
        "assign_clusters, counts exact, sums and inertia within 1e-4")

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
    moved = n * d * 4 + 5 * n + 8 * k * d + 4 * k + 4
    # the scores as three TF32 products on the tensor cores; and the same
    # work's fp32 CUDA-core bound
    b, by = bound(moved, 3 * 2.0 * n * k * d, PEAK_TF32)
    b32, _ = bound(moved, 2.0 * n * k * d)
    return dict(name="fused_masked_assign_update", route="cuda",
                source="src/repro_torch/csrc/fused.cu",
                replaces="src/repro/kernels/distance/fused.py:42",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib, bound_fp32_ms=b32,
                rechecks=rechecks, sass=sass,
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


def attention_work(b, s, h, kv, d, itemsize, causal) -> tuple:
    """(bytes, operations) that attention must move and do: q, k, v read
    once and o written once; 2 * 2 * D operations per live (query, key)
    pair (the causal ones only: this run's queries and keys align)."""
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * itemsize
    pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * s
    return nbytes, 4.0 * d * pairs


def close_to_plain(torch, aref, out, ref, ref32, dt: str,
                   what: str) -> tuple:
    """Hold an attention output against the plain version: elementwise
    against ``ref`` (the plain version in the inputs' dtype) and per query
    block against ``ref32`` (in fp32).  Returns (max |err|, block error)."""
    err = float((out.float() - ref.float()).abs().max())
    tol = ATTN_TOL[dt]
    check(bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)),
          f"{what}: differs from the plain version by up to {err}")
    blk = aref.block_error(out, ref32)
    check(blk <= ATTN_BLOCK_TOL[dt],
          f"{what}: a 128-row query block differs from the plain version "
          f"by {blk} of its norm (limit {ATTN_BLOCK_TOL[dt]})")
    return err, blk


def kernel_attention(torch, mods, sass: dict) -> dict:
    aops, aref = mods["aops"], mods["aref"]
    F = torch.nn.functional
    by_route = aops.flash_attention.launches_by_route
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    row = None
    for what, b, s, h, kv, d, dt, causal in ATTN_SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, h, d, generator=g, device=DEV).to(dtype)
        k = torch.randn(b, s, kv, d, generator=g, device=DEV).to(dtype)
        v = torch.randn(b, s, kv, d, generator=g, device=DEV).to(dtype)
        route = ATTN_ROUTE[dt]
        label = (f"{what} (B={b} S={s} H={h} KV={kv} D={d} {dt} "
                 f"causal={causal})")
        before = by_route[route]
        out = aops.flash_attention(q, k, v, causal=causal)
        again = aops.flash_attention(q, k, v, causal=causal)
        check(by_route[route] == before + 2,
              f"flash attention {label}: did not take the {route!r} route "
              f"({by_route})")
        ref32 = aref.attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal)
        ref = ref32.to(dtype)   # what attention_ref(q, k, v) gives
        torch.cuda.synchronize()
        err, blk = close_to_plain(torch, aref, out, ref, ref32, dt,
                                  f"flash attention {label}")
        check(bool(torch.equal(out, again)),
              f"flash attention {label}: two launches differ")
        del again
        ms = time_ms(torch, lambda: aops.flash_attention(q, k, v,
                                                         causal=causal),
                     reps=10)
        nbytes, ops = attention_work(b, s, h, kv, d, q.element_size(), causal)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        bnd, by = bound(nbytes, ops, peak)
        log(f"flash attention {label}: route {route}, max |err| {err!r} "
            f"(tol {ATTN_TOL[dt]}), block error {blk!r} (tol "
            f"{ATTN_BLOCK_TOL[dt]}), two launches bitwise equal, {ms:.4f} ms, "
            f"{ops:.4g} operations, {ops / ms / 1e9:.1f} TFLOP/s, bound "
            f"{bnd:.4f} ms ({by}, {dt})")
        if row is not None:
            del ref, ref32
            continue
        # the serving shape: the CUDA-core route on the same bf16 inputs
        # (the kernel the tensor-core one replaced on this path, and still
        # the bf16 route at other widths), checked and timed; the plain
        # version and SDPA
        simt_out = aops._launch(q, k, v, causal, "simt")
        torch.cuda.synchronize()
        simt_err, simt_blk = close_to_plain(
            torch, aref, simt_out, ref, ref32, dt,
            f"flash attention {label} on \"simt\"")
        log(f"flash attention {label}: route simt on the same inputs, max "
            f"|err| {simt_err!r}, block error {simt_blk!r}")
        del simt_out, ref, ref32
        simt = time_ms(torch, lambda: aops._launch(q, k, v, causal, "simt"),
                       reps=3)
        plain = time_ms(torch, lambda: aref.attention_ref(q, k, v,
                                                          causal=causal),
                        reps=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=10)
        b32, _ = bound(nbytes, ops, PEAK_FP32)
        log(f"flash attention {label}: tc {ms!r} ms, simt {simt!r} ms, "
            f"plain {plain!r} ms, SDPA {lib!r} ms")
        row = dict(name="flash_attention", route="cuda",
                   source="src/repro_torch/csrc/flash_sm90.cu",
                   replaces="src/repro/kernels/attention/attention.py:42",
                   max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                   bound_by=by, library_ms=lib, bound_fp32_ms=b32,
                   block_error=blk, simt_ms=simt, simt_max_abs_err=simt_err,
                   simt_block_error=simt_blk, sass=sass,
                   shape=f"B={b} S={s} H={h} KV={kv} D={d} {dt} "
                         f"causal={causal}",
                   library_call="torch.nn.functional."
                                "scaled_dot_product_attention")
        del q, k, v, qt, kt, vt
    return row


@contextlib.contextmanager
def plain_attention(mods):
    """The layers' one attention call patched to the plain version, for the
    length of the block (the package has no switch for it)."""
    layers, aref = mods["layers"], mods["aref"]
    saved = layers.flash_attention
    layers.flash_attention = (
        lambda q, k, v, causal=True: aref.attention_ref(q, k, v,
                                                        causal=causal))
    try:
        yield
    finally:
        layers.flash_attention = saved


def lm_serving_path(torch, mods, counters) -> dict:
    """Slice 3's main path: LM serving at OLMo-1B's full width."""
    serve, lm, configs = mods["serve"], mods["lm"], mods["configs"]
    cfg = configs.get_config(SERVE["arch"])
    # first-call set-up (cuBLAS handles, the kernel library) outside the
    # timed run
    t0 = time.time()
    serve.serve_batch(arch=SERVE["arch"], smoke=False, batch=1, prompt_len=64,
                      gen=2, device=DEV, seed=SEED)
    log(f"serve warm-up (batch 1, prompt 64): {time.time() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t0 = time.time()
    out = serve.serve_batch(smoke=False, device=DEV, seed=SEED, **SERVE)
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    by_route = dict(counters["flash_attention"].launches_by_route)
    check(launches["flash_attention"] == cfg.n_layers,
          f"serve: {launches['flash_attention']} flash launches for "
          f"{cfg.n_layers} layers (one per prefill layer, none in decode)")
    check(by_route == {"tc": cfg.n_layers, "simt": 0},
          f"serve: flash launches by route {by_route}; every prefill layer "
          f"must take the tensor-core route")
    check(all(n == 0 for name, n in launches.items()
              if name != "flash_attention"),
          f"serve: a mining kernel launched: {launches}")
    check(out["logits_finite"], "serve: a logit is not finite")
    gen = out["generated"]
    check(gen is not None and tuple(gen.shape) == (SERVE["batch"],
                                                   SERVE["gen"]),
          f"serve: generated {None if gen is None else tuple(gen.shape)}")
    check(bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          "serve: a token outside the vocabulary")
    log(f"serve {SERVE['arch']} full width bf16 (batch {SERVE['batch']}, "
        f"prompt {SERVE['prompt_len']}, gen {SERVE['gen']}): prefill_s "
        f"{out['prefill_s']!r}, decode_s {out['decode_s']!r} "
        f"({out['decode_s'] / SERVE['gen'] * 1e3:.3f} ms per token), "
        f"tokens_per_s {out['tokens_per_s']!r}, wall with weight init "
        f"{wall:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
        f"launches {launches['flash_attention']} by route {by_route}, all "
        f"logits finite")
    del out
    profile_serving(torch, mods, cfg)

    # the kernel route against the plain route, fp32, same weights/prompts
    c = SERVE_CHECK
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_params(g, cfg32, device=DEV)
    prompts = torch.randint(0, cfg.vocab, (c["batch"], c["prompt_len"]),
                            generator=g, device=DEV)
    reset(counters)
    a = serve.generate(params, prompts, cfg32, gen=c["gen"])
    check(counters["flash_attention"].launches_by_route["simt"]
          == counters["flash_attention"].launches == cfg.n_layers,
          "fp32 check: the kernel route did not launch the CUDA-core kernel "
          "once per layer")
    with plain_attention(mods):
        reset(counters)
        b = serve.generate(params, prompts, cfg32, gen=c["gen"])
        check(counters["flash_attention"].launches == 0,
              "fp32 check: the plain route launched the kernel")
    la = a["prefill_logits"][..., :cfg.vocab]
    lb = b["prefill_logits"][..., :cfg.vocab]
    diff = float((la - lb).abs().max())
    scale = float(lb.abs().max())
    check(a["logits_finite"] and b["logits_finite"],
          "fp32 check: a logit is not finite")
    check(diff <= SERVE_LOGIT_RTOL * scale,
          f"fp32 check: prefill logits differ by {diff} (largest |logit| "
          f"{scale}, limit {SERVE_LOGIT_RTOL} relative)")
    check(bool(torch.equal(a["generated"], b["generated"])),
          "fp32 check: greedy tokens differ between the kernel and plain "
          "routes")
    log(f"serve fp32 check (batch {c['batch']}, prompt {c['prompt_len']}, "
        f"gen {c['gen']}): kernel vs plain route prefill logits max |diff| "
        f"{diff!r} of largest |logit| {scale!r} "
        f"(rel {diff / scale!r}), {c['gen']} greedy tokens equal; prefill_s "
        f"kernel {a['prefill_s']!r} / plain {b['prefill_s']!r}")
    del params, a

    # bf16 (the serving dtype) on the same draws, printed, not gated
    g = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_params(g, cfg, device=DEV)
    a16 = serve.generate(params, prompts, cfg, gen=c["gen"])
    with plain_attention(mods):
        b16 = serve.generate(params, prompts, cfg, gen=c["gen"])
    l16 = a16["prefill_logits"][..., :cfg.vocab]
    log(f"serve bf16 (same draws, same shape): prefill logits max |diff| "
        f"from the fp32 plain route "
        f"{float((l16 - lb).abs().max())!r}, from the bf16 plain route "
        f"{float((l16 - b16['prefill_logits'][..., :cfg.vocab]).abs().max())!r}"
        f"; greedy tokens equal to fp32: "
        f"{bool(torch.equal(a16['generated'], b['generated']))}")
    return {"flash_attention": launches["flash_attention"]}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile_window(torch, label, fn) -> dict:
    """Run ``fn`` under ``torch.profiler``; print the device's busy share of
    the window's wall time and the kernels that took the most device time,
    and return the wall, the busy time and each kernel's time (ms).  Only
    the device's own entries (kernels, copies, memsets) are summed: the
    host ops that launched them carry the same time again."""
    prof_mod = torch.profiler
    acts = [prof_mod.ProfilerActivity.CPU, prof_mod.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with prof_mod.profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    device = torch.autograd.DeviceType.CUDA
    evts = [e for e in prof.key_averages()
            if e.device_type == device and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in evts)
    top = sorted(evts, key=_device_us, reverse=True)[:6]
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms (profiler on), "
        f"device busy {busy / 1e3:.3f} ms = {busy / wall_us:.3f} of the "
        f"wall, {sum(e.count for e in evts)} device ops; top: " + "; ".join(
            f"{e.key[:60]} x{e.count} {_device_us(e) / 1e3:.3f} ms"
            for e in top))
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                by_kernel={e.key: (e.count, _device_us(e) / 1e3)
                           for e in evts})


def profile_serving(torch, mods, cfg) -> None:
    """Where the serving path's time goes: prefill and 8 decode steps at
    the timed run's shape, each under the profiler."""
    lm = mods["lm"]
    g = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init_params(g, cfg, device=DEV)
    b, p, n = SERVE["batch"], SERVE["prompt_len"], 8
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=g, device=DEV)
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill_step(
            params, prompts, cfg, max_seq=p + n)

    def decode():
        logits, cache = state["logits"], state["cache"]
        for i in range(n):
            tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            logits, cache = lm.decode_step(params, cache, tok, p + i, cfg)

    # the profiler's first window pays its own set-up (seconds): spend it
    # on a trivial one
    profile_window(torch, "warm-up", lambda: torch.ones(8, device=DEV) + 1)
    profile_window(torch, f"prefill (batch {b}, prompt {p})", prefill)
    profile_window(torch, f"decode ({n} steps, batch {b})", decode)


def workdir(mods, prefix: str) -> str:
    """A new directory under the run's scratch root, removed at exit."""
    return tempfile.mkdtemp(prefix=prefix, dir=mods["tmp"])


def reset(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
        by_route = getattr(fn, "launches_by_route", None)
        if by_route is not None:
            for route in by_route:
                by_route[route] = 0


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


def _svc_workload(serve_mine, algo, shape, seed, requests=SVC_REQUESTS):
    return serve_mine.build_workload(
        requests, 4, algo, features=shape["features"],
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


def profile_lane_batch(torch, mods, warm) -> None:
    """Where one K-Means batch of the kernel lane spends its time: a batch
    of new requests on a service of its own (warmed as the main one), under
    the profiler; its device time split into the fused step's kernels and
    the rest, beside the lane's exec_s - host_s for the batch (a residual
    on the host clock)."""
    work = _svc_workload(mods["serve_mine"], "kmeans", SVC_KMEANS, SEED + 7,
                         requests=SVC_MAX_BATCH)
    svc = _svc(mods, workdir(mods, "prof_"), warm_start=warm)
    svc.start()
    try:
        profile_window(torch, "warm-up",
                       lambda: torch.ones(8, device=DEV) + 1)
        prof = profile_window(
            torch, f"service K-Means batch ({len(work)} requests, "
                   f"cuda-kernel)",
            lambda: _drive(mods, svc, work, "cuda-kernel"))
    finally:
        svc.stop()   # joins the lane: the batch is recorded after this
    lane = svc.metrics_snapshot()["by_executor"]["cuda-kernel"]
    fused = [(key, cnt, ms) for key, (cnt, ms) in prof["by_kernel"].items()
             if any(name in key for name in ("fused_partials_kernel",
                                             "reduce_partials_kernel",
                                             "pack_centroids"))]
    fused_ms = sum(ms for _k, _c, ms in fused)
    resid = lane["exec_s"] - lane["host_s"]
    log(f"service K-Means batch profile: device busy {prof['busy_ms']:.3f} "
        f"ms of {prof['wall_ms']:.3f} ms wall; the fused step's kernels "
        f"{fused_ms:.3f} ms (" + "; ".join(
            f"{key[:40]} x{cnt} {ms:.3f} ms" for key, cnt, ms in fused)
        + f"), other device work {prof['busy_ms'] - fused_ms:.3f} ms; the "
        f"lane's exec_s - host_s {resid:.3f} s (exec_s {lane['exec_s']:.3f}"
        f" s, host_s {lane['host_s']:.3f} s, {lane['batches']} batch(es))")


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
    profile_lane_batch(torch, mods, warm)
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
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as aops, ref as aref
    from repro_torch.kernels.distance import fused as fops
    from repro_torch.kernels.distance import ops as dops, ref as dref
    from repro_torch.kernels.neighbor import ops as nops, ref as nref
    from repro_torch.launch import mine, serve, serve_mine
    from repro_torch.models import layers, lm
    from repro_torch.runtime import backend
    from repro_torch import service

    mods = dict(dops=dops, dref=dref, fops=fops, nops=nops, nref=nref,
                synth=synth, mine=mine, kmeans=kmeans, dbscan=dbscan,
                cancel=cancel, serve_mine=serve_mine, service=service,
                aops=aops, aref=aref, serve=serve, lm=lm, layers=layers,
                configs=configs)
    counters = {"assign_clusters": dops.assign_clusters,
                "fused_masked_assign_update": fops.fused_masked_assign_update,
                "epsilon_degree": nops.epsilon_degree,
                "expand_frontier": nops.expand_frontier,
                "flash_attention": aops.flash_attention}
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
            sass = build(_build)
            rows = [kernel_assign(torch, mods, sass["distance"]),
                    kernel_fused(torch, mods, sass["fused"])]
            wide_rows(torch, mods)
            rows += [*kernel_neighbor(torch, mods),
                     kernel_attention(torch, mods, sass["flash_sm90"])]
            t_path = time.time()
            mine_launches = main_path(torch, mods, counters)
            log(f"one-job path: {time.time() - t_path:.1f} s, launches "
                f"{mine_launches}")
            t_path = time.time()
            svc_launches = service_path(torch, mods, counters)
            log(f"service path: {time.time() - t_path:.1f} s, launches "
                f"{svc_launches}")
            t_path = time.time()
            lm_launches = lm_serving_path(torch, mods, counters)
            log(f"LM serving path: {time.time() - t_path:.1f} s, launches "
                f"{lm_launches}")
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
    launches.update(lm_launches)
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
                        "launches_lm_path": lm_launches.get(row["name"]),
                        "max_err": row["max_abs_err"],
                        "library_ms": row["library_ms"],
                        "library_call": row.get("library_call"),
                        "kernel_only_ms": row.get("kernel_only_ms"),
                        "launch_shape": row.get("launch_shape"),
                        "bound_fp32_ms": row.get("bound_fp32_ms"),
                        "block_error": row.get("block_error"),
                        "simt_ms": row.get("simt_ms"),
                        "simt_max_abs_err": row.get("simt_max_abs_err"),
                        "simt_block_error": row.get("simt_block_error"),
                        "sass": row.get("sass"),
                        "rechecks": row.get("rechecks"),
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
