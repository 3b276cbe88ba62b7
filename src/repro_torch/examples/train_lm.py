"""End-to-end LM training driver: a small model, a few hundred steps, with
checkpointing and job persistence (host-friendly scale).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

The counterpart of the reference's ``examples/train_lm.py``.
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import run_training_job


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_train_")

    out = run_training_job(
        arch=args.arch, smoke=True, steps=args.steps, batch=args.batch,
        seq=args.seq, workdir=workdir, schedule="wsd", ckpt_every=50,
        device=args.device,
    )
    losses = out["losses"]
    if losses:
        k = max(1, len(losses) // 10)
        first = sum(losses[:k]) / k
        last = sum(losses[-k:]) / k
        print(f"loss: {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    print(f"final: {out['final_state']} after {out['steps_done']} steps "
          f"(workdir {workdir})")
    return out


if __name__ == "__main__":
    main()
