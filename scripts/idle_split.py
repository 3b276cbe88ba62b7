#!/usr/bin/env python3
"""Splits a traced benchmark run's device-idle time over the program's
spans.

    python3 scripts/idle_split.py --workload <cell> --seed <n> \
        [--seconds 30] [--out FILE]

From the root of a checkout, on a CUDA card.  Runs the cell once as
``portbench/run.py --trace 1`` does and prints one JSON line: the run's
``metrics`` and ``breakdown``, and ``idle_by_span``, the window's idle
gaps (no kernel, copy or set on the card) summed in seconds by the
innermost span running at each gap's middle, counting only the
program's spans (``repro_torch.*``) and the benchmark's
(``portbench.*``); ``idle_in_span`` gives, for the gaps inside each such
span, the innermost host operation of any kind.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIXES = ("repro_torch.", "portbench.")


def gaps(trace) -> list:
    """The window's idle gaps as (start, end) in microseconds."""
    from portbench import tracing

    out, t = [], trace.start
    for a, b in tracing.merged(trace.device):
        if a > t:
            out.append((t, min(a, trace.end)))
        t = max(t, b)
    if t < trace.end:
        out.append((t, trace.end))
    return out


def split(trace) -> dict:
    from portbench import tracing

    spans = [iv for iv in trace.host if iv[0].startswith(PREFIXES)]
    idle = gaps(trace)
    mids = [(a + b) / 2 for a, b in idle]
    by_span = defaultdict(float)
    in_span = defaultdict(lambda: defaultdict(float))
    for (a, b), span, op in zip(idle, tracing._hosts_at(spans, mids),
                                tracing._hosts_at(trace.host, mids)):
        key = span or "(no span)"
        by_span[key] += (b - a) / 1e6
        in_span[key][op or "(no host op)"] += (b - a) / 1e6
    top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])
    return {"idle_s": sum(by_span.values()),
            "idle_by_span": top(by_span, 20),
            "idle_in_span": {k: top(v, 6) for k, v in in_span.items()
                             if by_span[k] >= 0.01 * sum(by_span.values())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import run, tracing

    run._cache_dirs(ROOT)
    held = {}
    breakdown = tracing.breakdown

    def keep(trace, top=10):
        held["trace"] = trace
        return breakdown(trace, top)

    tracing.breakdown = keep
    result = run.run_cell(args.workload, args.seed, args.seconds, True)
    line = json.dumps({"workload": args.workload, "seed": args.seed,
                       "correct": result["correct"],
                       "attempted": result["attempted"],
                       "metrics": result["metrics"],
                       "device": result["device"],
                       "breakdown": result["breakdown"],
                       **split(held["trace"])})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
