#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out FILE]

For each seed of ``--seeds``: the cell's first job of that seed (its
dataset 0, job 0), run through the cell's entry on the card at the
cell's size, and the numbers the check compares.  For each seed of
``--control-seeds``: the control, the plain reference computed in the
precision below the configuration's and put in the program's place
(``control`` in ``portbench/checks/<algorithm>.py``), and the same
numbers.  One JSON line each, to standard output and to ``--out``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell_name: str, seeds, control_seeds, device: str = "cuda",
             config: dict = None):
    """Yields one dict a reading."""
    from portbench import drive, inputs, spec
    from repro_torch.runtime import backend

    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    config = config or spec.config(bench, cell["config"])
    traffic = dict(spec.traffic(cell["traffic"]), datasets=1)
    dev = backend.load(device).device
    compare = spec.comparison(config["algorithm"])

    def program(seed) -> dict:
        data = inputs.datasets(config, seed, 1, dev)
        e = drive.entry(config, traffic, data, seed,
                        inputs.shared(config, seed, dev))
        job = drive.Job(0, 0, e.fetch(e.run(0), True), {})
        return compare.check(e, config, data, seed, [job])[0]

    def control(seed) -> dict:
        return compare.control(config, inputs.datasets(config, seed, 1, dev),
                               seed, inputs.shared(config, seed, dev))

    for side, fn, group in (("program", program, seeds),
                            ("control", control, control_seeds)):
        for seed in group:
            t0 = time.time()
            nums = fn(seed)
            yield {"cell": cell_name, "side": side, "seed": seed,
                   "numbers": nums, "s": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, args.seeds, args.control_seeds):
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
