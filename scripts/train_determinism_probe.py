#!/usr/bin/env python3
"""Which parts of a training step give other bits from run to run on one
CUDA card.

    python3 scripts/train_determinism_probe.py [--archs A ...] [--batch 2]
        [--seq 2048]

For each arch (by default the six of the MoE, Mamba, hybrid and
stub-frontend families at their published widths cut to one layer group,
jamba at its smoke config, and OLMo-1B at 2 layers), bf16, the step-1 loss
and gradients of one synthetic batch are computed from the same params

1. twice, as the port computes them: the gradient leaves whose bits differ;
2. once under ``torch.use_deterministic_algorithms(True, warn_only=True)``:
   every op PyTorch knows to lack a deterministic CUDA form warns, and the
   distinct warnings are listed (the switch is this probe's alone; the
   library never sets it);
3. twice with the MoE FFN's row moves as plain ``gather`` under autograd,
   whose backward is a float scatter-add with atomics (the dispatch's form
   before ``models/moe._Rows``): the leaves whose bits differ.

Prints the card (``nvidia-smi``) and one JSON line an arch.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("internvl2-26b", "musicgen-medium", "olmoe-1b-7b",
            "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b", "jamba-v0.1-52b")


def grads_twice(torch, cfg, batch: int, seq: int) -> tuple:
    """(loss bits equal, leaves, the names of the leaves that differ)."""
    import chip_smoke
    from repro_torch.models import lm
    from repro_torch.train import step as tstep

    gen = torch.Generator(device="cuda").manual_seed(2)
    params = tstep.as_trainable(lm.init_params(gen, cfg, device="cuda"))
    data = tstep.make_train_batch(gen, cfg, batch, seq)
    runs = []
    for _ in range(2):
        loss, _parts, grads = tstep.loss_and_grads(params, data, cfg)
        runs.append((loss.detach(), grads))
    (l1, g1), (l2, g2) = runs
    a, b = dict(chip_smoke._named_leaves(g1)), dict(
        chip_smoke._named_leaves(g2))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    out = bool(torch.equal(l1, l2)), len(a), differ
    del params, data, runs, g1, g2, a, b
    torch.cuda.empty_cache()
    return out


def deterministic_warnings(torch, cfg, batch: int, seq: int) -> list:
    from repro_torch.models import lm
    from repro_torch.train import step as tstep

    gen = torch.Generator(device="cuda").manual_seed(2)
    params = tstep.as_trainable(lm.init_params(gen, cfg, device="cuda"))
    data = tstep.make_train_batch(gen, cfg, batch, seq)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            tstep.loss_and_grads(params, data, cfg)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    del params, data
    torch.cuda.empty_cache()
    return sorted({str(w.message).split("\n")[0] for w in seen
                   if "determinis" in str(w.message)})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=[*FAMILIES, "olmo-1b"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    # cuBLAS is deterministic on one stream with this workspace; without it
    # the deterministic mode flags every matrix product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("train_determinism_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.runtime import backend

    print(f"card: {chip_smoke.card_line()}", flush=True)
    backend.load("cuda")
    for arch in args.archs:
        depth = ("smoke" if arch == "jamba-v0.1-52b" else
                 2 if arch == "olmo-1b" else "group")
        cfg = chip_smoke._family_cfg(configs, arch, depth)
        loss_eq, leaves, differ = grads_twice(torch, cfg, args.batch,
                                              args.seq)
        warned = deterministic_warnings(torch, cfg, args.batch, args.seq)
        line = dict(arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
                    batch=args.batch, seq=args.seq, leaves=leaves,
                    loss_equal=loss_eq, differ=differ,
                    deterministic_mode_warnings=warned)
        if cfg.n_experts:
            rows = moe._Rows
            moe._Rows = type("PlainRows", (), {"apply": staticmethod(
                lambda src, idx, ok, _back, _back_ok: moe._pick(src, idx,
                                                                ok))})
            try:
                p_eq, _n, p_differ = grads_twice(torch, cfg, args.batch,
                                                 args.seq)
            finally:
                moe._Rows = rows
            line.update(plain_dispatch_loss_equal=p_eq,
                        plain_dispatch_differ=p_differ)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
