#!/usr/bin/env python3
"""Split the K-Means kernels' wide search (d > ops.WIDE_D) into its parts,
on one CUDA card, by timing variants of a checkout's sources with parts
switched off.

    python3 scripts/kmeans_wide_split.py [TREE] [--pod]
        [--variants base,...] [--out FILE]

TREE is the root of a checkout, or of a copy of its ``src/`` (default:
this one).  Its ``csrc/distance.cu`` and ``csrc/fused.cu`` are built by
``nvcc`` into ``TREE/build/wide_split/`` once as they are and once per
variant, each a text patch of the sources; TREE's own wrappers
(``kernels/distance/ops.py``, ``fused.py``) then launch each variant's
libraries.  The patches follow TREE's wide form: the first one
(``search_tile_wide``, the 64-point tiles that PERF.md's Step 0 split)
or the second (``search_wide_kernel``); a patch that does not apply is an
error.  The variants:

- ``no_recheck``: the exact rechecks of the window's candidates skipped
  (the candidates are dropped), so the time left is the products, the
  streaming of the boxes and the window;
- ``no_recheck_no_mma``: as ``no_recheck``, and the tensor-core products
  left out too: the streaming of the boxes, the barriers, the window;
- ``one_range`` (the first form): the fused step's sums of the first
  range of centroids only: what the re-walks of the tiles for the
  further ranges cost;
- ``no_sums`` (the second form): the fused step's search alone, its sums
  kernel not launched.

Shapes:

- ``1e``: the assignment at the embedding fit's shape, n 1,024, d 2,048,
  k 4 (centroids drawn from the unit-norm points);
- ``2p-sub``: pass 1 of the fused step at the pod-scale cell's widths, d
  128, k 4,096, over 31 partial blocks of TILES 64-row tiles (the
  pod-scale launch's 31 blocks, each with TILES of its 8,457 tiles),
  and over 132 such blocks; the first form's time scales to a 2-shard
  shard's (15 blocks of 8,457 tiles) by 8,457 / TILES;
- ``2p`` (``--pod``, the base variant alone): pass 1 over the first
  2-shard shard of the pod-scale cell itself, n 8,118,720 (15 blocks of
  541,248 rows).

Each is timed with CUDA events (mean of REPS launches after one warm-up)
and its rechecks per point read (``ops.rechecks``).  At 1e the queued
calls' event mean reads the host's rate of calls, so 1e also gets the
device time of a call (GRAPH_CALLS calls captured in a CUDA graph, its
replays timed by events), the host microseconds a call, and the same
three for the library call ``cdist(x, c).argmin(1)``; the base variant
also times the embedding fit's whole Lloyd loop there (``core.kmeans.fit``,
k-means++, host wall to a synchronise, mean of FITS fits).  Prints the
card (``nvidia-smi``), one JSON line per (shape, variant) and a JSON
summary last; ``--out`` writes the summary.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = 256
REPS = {"1e": 50, "2p-sub": 3, "2p": 3}
GRAPH_CALLS = 20
FITS = 20
POD_SHARD = 8118720

_WGMMA_FIRST = (
    "      wgmma_tf32<NT>(acc, al[kk], dh, kb + kk > 0);\n"
    "      wgmma_tf32<NT>(acc, ah[kk], smem_desc(lo_s + kk * 32), 1);\n"
    "      wgmma_tf32<NT>(acc, ah[kk], dh, 1);\n")
# the second form's products: A from x's resident images, or from registers
_WGMMA_SECOND = (
    "            wgmma_tf32_ss<NT>(acc, smem_desc(xlo_s + ao + kk * 32), dh,\n"
    "                              kb + kk > 0);\n"
    "            wgmma_tf32_ss<NT>(acc, ah, smem_desc(lo_s + kk * 32), 1);\n"
    "            wgmma_tf32_ss<NT>(acc, ah, dh, 1);\n")
_WGMMA_SECOND_REGS = (
    "            wgmma_tf32<NT>(acc, al[kk], dh, kb + kk > 0);\n"
    "            wgmma_tf32<NT>(acc, ah[kk], smem_desc(lo_s + kk * 32), 1);\n"
    "            wgmma_tf32<NT>(acc, ah[kk], dh, 1);\n")
_RECHECK_FIRST = ("assign_common.cuh", "pending &= live;",
                  "pending = 0u * live;")
# the second form's deferred rechecks at the end of a tile
_RECHECK_SECOND = ("assign_common.cuh",
                   "        if (!(hs[i] > cut)) m |= 1u << i;",
                   "        (void)cut;")
# Each form's variants: (name, [(file, old text, new text), ...]).
FIRST_FORM = [
    ("base", []),
    ("no_recheck", [_RECHECK_FIRST]),
    ("no_recheck_no_mma", [
        _RECHECK_FIRST,
        ("assign_common.cuh", _WGMMA_FIRST, "      (void)dh;\n")]),
    ("one_range", [("fused.cu", "const int ranges = (k + acc_k - 1) / acc_k;",
                    "const int ranges = 1;")]),
]
SECOND_FORM = [
    ("base", []),
    ("no_recheck", [_RECHECK_SECOND]),
    ("no_recheck_no_mma", [
        _RECHECK_SECOND,
        ("assign_common.cuh", _WGMMA_SECOND,
         "            (void)ah;\n            (void)dh;\n"),
        ("assign_common.cuh", _WGMMA_SECOND_REGS, "            (void)dh;\n")]),
    ("no_sums", [("fused.cu",
                  "    wide_sums_kernel<<<grid, kSumsThreads, smem, s>>>(",
                  "    if (n < 0) wide_sums_kernel<<<grid, kSumsThreads, "
                  "smem, s>>>(")]),
]


def variants_of(csrc: Path) -> list:
    """The variants that follow the wide form of the sources in csrc."""
    second = "search_wide_kernel" in (csrc / "assign_common.cuh").read_text()
    return SECOND_FORM if second else FIRST_FORM


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_variants(tree: Path, build_mod, variants: list) -> dict:
    """{variant: {lib name: path}}; every nvcc is started at once."""
    out_dir = tree / "build" / "wide_split"
    shutil.rmtree(out_dir, ignore_errors=True)
    csrc = tree / "src" / "repro_torch" / "csrc"
    procs, paths = [], {}
    for name, patches in variants:
        src = out_dir / name / "csrc"
        shutil.copytree(csrc, src)
        for fname, old, new in patches:
            text = (src / fname).read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: its patch of {fname} "
                                 f"does not apply to {tree}")
            (src / fname).write_text(text.replace(old, new))
        paths[name] = {}
        for lib in ("distance", "fused"):
            so = out_dir / name / f"{lib}.so"
            cmd = [build_mod.cuda_tool("nvcc"), *build_mod.NVCC_FLAGS, "-I",
                   str(src), "-o", str(so), str(src / f"{lib}.cu")]
            procs.append((name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            paths[name][lib] = so
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}/{lib}:\n{out}")
        # ptxas's registers, stack and spills beside each library
        paths[name][lib].with_suffix(".log").write_text(out)
    return paths


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def time_ms(torch, fn, reps: int) -> float:
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


def graph_ms(torch, fn, calls: int = GRAPH_CALLS, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, the replays timed by CUDA events (the host's launch cost left
    out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def host_us(torch, fn, reps: int = 50) -> float:
    """Host microseconds a call, the calls queued without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--pod", action="store_true",
                    help="also time pass 1 over a 2-shard shard of the "
                         "pod-scale cell (the base variant)")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to build (default: all "
                         "of TREE's form)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    variants = variants_of(tree / "src" / "repro_torch" / "csrc")
    if args.variants:
        keep = args.variants.split(",")
        variants = [v for v in variants if v[0] in keep]
    sys.path.insert(0, str(tree / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kmeans_wide_split: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.core import kmeans
    from repro_torch.kernels.distance import fused as fops, ops as dops

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    paths = build_variants(tree, _build, variants)
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    summary = {"card": card, "tree": str(tree), "tiles": TILES, "rows": []}

    def record(row):
        print(json.dumps(row), flush=True)
        summary["rows"].append(row)

    # 1e: the embedding fit's shape
    n, d, k = 1024, 2048, 4
    x = torch.randn(n, d, generator=gen)
    x = (x / x.norm(dim=1, keepdim=True)).to(dev)
    c = x[torch.randperm(n, generator=gen)[:k].to(dev)].contiguous()
    # 2p-sub: the pod-scale widths, 31 and 132 blocks of TILES tiles
    d2, k2 = 128, 4096
    tm = dops.plan(1 << 24, k2, d2).tm
    subs = {}
    for blocks in (31, 132):
        n2 = blocks * TILES * tm
        g2 = torch.Generator(device=dev).manual_seed(blocks)
        c2 = torch.randn(k2, d2, generator=g2, device=dev) * 4
        x2 = c2[torch.randint(0, k2, (n2,), generator=g2, device=dev)] + \
            torch.randn(n2, d2, generator=g2, device=dev)
        subs[blocks] = (x2, c2, torch.ones(n2, dtype=torch.bool,
                                           device=dev))

    def lib_1e():
        return torch.cdist(x, c).argmin(1)

    record(dict(variant="library cdist(x, c).argmin(1)", shape="1e", n=n,
                d=d, k=k, ms=time_ms(torch, lib_1e, REPS["1e"]),
                device_ms=graph_ms(torch, lib_1e),
                host_us=host_us(torch, lib_1e)))
    for name, _ in variants:
        libs = paths[name]
        # the tree's wrappers load these libraries from here on
        _build._libs["distance"] = load(libs["distance"], dops._SIGNATURES)
        _build._libs["fused"] = load(libs["fused"], fops._SIGNATURES)

        def assign_1e():
            return dops.assign_clusters(x, c)

        ms = time_ms(torch, assign_1e, REPS["1e"])
        total, most = dops.rechecks(dops.assign_clusters)
        row = dict(variant=name, shape="1e", n=n, d=d, k=k, ms=ms,
                   device_ms=graph_ms(torch, assign_1e),
                   host_us=host_us(torch, assign_1e),
                   rechecks_per_point=total / n, rechecks_most=most,
                   plan=list(dops.plan(n, k, d)))
        if name == "base":
            cfg = kmeans.KMeansConfig(k=k, init="kmeans++")
            res = kmeans.fit(2, x, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FITS):
                res = kmeans.fit(2, x, cfg)
            torch.cuda.synchronize()
            row.update(fit_ms=(time.perf_counter() - t0) / FITS * 1e3,
                       fit_iterations=int(res.iterations))
        record(row)
        for blocks, (x2, c2, m2) in subs.items():
            ms = time_ms(torch, lambda: fops.fused_masked_partials(
                x2, c2, m2, TILES * tm), REPS["2p-sub"])
            total, most = dops.rechecks(fops.fused_masked_assign_update)
            n2 = x2.shape[0]
            record(dict(variant=name, shape="2p-sub", blocks=blocks, n=n2,
                        d=d2, k=k2, tiles_per_block=TILES,
                        acc_k=fops.launch_shape(n2, k2, d2)[2], ms=ms,
                        ms_scaled_first_form=ms * 8457 / TILES,
                        rechecks_per_point=total / n2,
                        rechecks_most=most))
    if args.pod:
        del subs
        _build._libs["distance"] = load(paths["base"]["distance"],
                                        dops._SIGNATURES)
        _build._libs["fused"] = load(paths["base"]["fused"],
                                     fops._SIGNATURES)
        g3 = torch.Generator(device=dev).manual_seed(3)
        c3 = torch.randn(k2, d2, generator=g3, device=dev) * 4
        x3 = c3[torch.randint(0, k2, (POD_SHARD,), generator=g3,
                              device=dev)]
        x3 += torch.randn(POD_SHARD, d2, generator=g3, device=dev)
        m3 = torch.ones(POD_SHARD, dtype=torch.bool, device=dev)
        rows = fops.block_rows(1 << 24, k2, d2)
        ms = time_ms(torch, lambda: fops.fused_masked_partials(
            x3, c3, m3, rows), REPS["2p"])
        total, most = dops.rechecks(fops.fused_masked_assign_update)
        record(dict(variant="base", shape="2p", n=POD_SHARD, d=d2, k=k2,
                    block_rows=rows, ms=ms,
                    rechecks_per_point=total / POD_SHARD,
                    rechecks_most=most))
    print(json.dumps(summary))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
