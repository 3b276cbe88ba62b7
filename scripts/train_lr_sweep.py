#!/usr/bin/env python3
"""An LM's loss over a few train steps at several peak learning rates, on
one CUDA card: the runs behind ``chip_smoke.py``'s ``TRAIN_LR``.

    python3 scripts/train_lr_sweep.py [--arch olmo-1b] [--layers N | --smoke]
        [--lrs 1e-4 3e-5 1e-5] [--steps 4] [--batch 16] [--seq 2048]
        [--fp32-lr 1e-4]

Each run is phase 3d (a)'s (or, with another ``--arch``, phase 3f (a)'s):
the arch at its published width (depth ``--layers``, every layer by
default; ``--smoke`` for its smoke config), bf16 weights, fp32 master, mu
and nu, remat "full", one fixed synthetic batch of ``--batch`` x ``--seq``
tokens (a stub frontend's prefix rows among them),
``make_train_step`` with the wsd schedule over ``--steps`` steps.
``--fp32-lr`` adds one run with fp32 weights, to tell the learning rate's
effect from bf16's.  Prints the card (``nvidia-smi``) and, per run, each
step's loss (and the MoE aux loss), gradient norm and wall seconds (host
clock to a device sync), one JSON line a run.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(torch, cfg, lr: float, steps: int, batch: int, seq: int) -> list:
    from repro_torch import optim
    from repro_torch.train import step as tstep

    state = tstep.init_train_state(0, cfg, device="cuda")
    data = tstep.make_train_batch(
        torch.Generator(device="cuda").manual_seed(0), cfg, batch, seq)
    train_step = tstep.make_train_step(cfg, optim.AdamWConfig(lr=lr),
                                       optim.make_schedule("wsd", steps))
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, data)
        loss = float(metrics["loss"])
        out.append({"loss": loss, "aux": float(metrics["aux"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "s": time.perf_counter() - t0})
    del state, data
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    depth = ap.add_mutually_exclusive_group()
    depth.add_argument("--layers", type=int, default=None)
    depth.add_argument("--smoke", action="store_true")
    ap.add_argument("--lrs", type=float, nargs="+", default=[1e-4, 3e-5, 1e-5])
    ap.add_argument("--fp32-lr", type=float, default=1e-4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch import configs
    from repro_torch.runtime import backend

    print(f"card: {chip_smoke.card_line()}", flush=True)
    backend.load("cuda")
    cfg = chip_smoke._family_cfg(configs, args.arch,
                                 "smoke" if args.smoke else args.layers)
    runs = [("bfloat16", lr) for lr in args.lrs]
    if args.fp32_lr:
        runs.append(("float32", args.fp32_lr))
    for dtype, lr in runs:
        steps = run(torch, dataclasses.replace(cfg, dtype=dtype), lr,
                    args.steps, args.batch, args.seq)
        print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers,
                          "dtype": dtype, "lr": lr, "steps": steps}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
