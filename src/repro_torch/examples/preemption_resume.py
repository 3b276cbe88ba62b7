"""Fault-tolerance demo: a training job is preempted mid-run (the Android
activity-suspend analogue), checkpoints, and a fresh launcher resumes it to
completion from the job store.

    PYTHONPATH=src python -m repro_torch.examples.preemption_resume
    PYTHONPATH=src python -m repro_torch.examples.preemption_resume \\
        --device cpu

The counterpart of the reference's ``examples/preemption_resume.py``; the
preemption comes after a given step (``--preempt-after``), not after a
wall-clock delay, so the demo suspends at the same step on any machine.
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.launch.train import run_training_job


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--preempt-after", type=int, default=12)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_resume_")
    print(f"workdir: {workdir}")
    job = dict(arch="olmo-1b", smoke=True, steps=args.steps, batch=4,
               seq=32, workdir=workdir, ckpt_every=5, device=args.device)

    # phase 1: start the job, preempt it after --preempt-after steps
    token = CancellationToken()

    def preempt(step: int, _loss: float) -> None:
        if step == args.preempt_after:
            token.cancel(CancelReason.PREEMPTION)

    out1 = run_training_job(token=token, on_step=preempt, **job)
    print(f"phase 1: {out1['final_state']} at step {out1['steps_done']}")
    if out1["final_state"] != "SUSPENDED":
        raise SystemExit("expected preemption")

    # phase 2: a fresh launcher attaches, finds the SUSPENDED job, resumes
    out2 = run_training_job(**job)
    print(f"phase 2: {out2['final_state']} at step {out2['steps_done']}")
    if out2["final_state"] != "SUCCEEDED" or out2["steps_done"] != args.steps:
        raise SystemExit("the resumed job did not finish")
    print("resume path verified: job finished across two launcher lifetimes")
    return out1, out2


if __name__ == "__main__":
    main()
