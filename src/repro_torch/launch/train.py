"""End-to-end training driver: jobs + checkpoints + preemption + watchdog.

This is the paper's app loop at cluster scale, as the reference's
``repro/launch/train.py``.  The lifecycle mirrors §II.A exactly:

1. attach to the job store; sweep orphans (the activity's reattach);
2. claim a job (new or SUSPENDED); restore its checkpoint if resuming;
3. hold a wake lock (HoldAlive heartbeats) and run steps, polling the
   cancellation token *between* steps;
4. on SIGTERM/cancel: emergency-checkpoint, mark SUSPENDED, exit clean;
5. on completion: final checkpoint, mark SUCCEEDED.

Runs on the CUDA card unless ``--device cpu`` is given; with no card and no
``--device cpu`` it raises instead of running on the host.  Small on the
host (smoke config):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 20 --device cpu --workdir "$(mktemp -d)"

The weights and the batch stream come from a seed that is the same in
every process (``zlib.crc32`` of the arch name, not ``hash``), so a job
resumed by a fresh launcher trains on the data the suspended one would
have seen.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
import zlib
from typing import Callable, Optional


from repro_torch.checkpoint.elastic import emergency_save
from repro_torch.checkpoint.store import AsyncCheckpointer, CheckpointStore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.cancellation import CancellationToken
from repro_torch.core.jobs import JobState, JobStore
from repro_torch.data.tokens import step_generator
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import make_schedule
from repro_torch.runtime import backend as backend_mod
from repro_torch.runtime.preemption import HoldAlive, PreemptionGuard
from repro_torch.runtime.watchdog import StepWatchdog
from repro_torch.train.step import (
    TrainState,
    as_trainable,
    init_train_state,
    make_train_batch,
    make_train_step,
)


def stable_seed(arch: str) -> int:
    """The run's seed: the same for ``arch`` in every process."""
    return zlib.crc32(arch.encode()) % 2**31


def restore_train_state(store: CheckpointStore, step: int,
                        like: TrainState) -> TrainState:
    """Checkpoint ``step`` as a TrainState on ``like``'s device: params as
    autograd leaves, ``rng`` on the host (a CPU generator's state)."""
    state = store.restore(step, like, device=like.step.device)
    return state._replace(params=as_trainable(state.params),
                          rng=state.rng.cpu())


def run_training_job(
    *,
    arch: str,
    smoke: bool,
    steps: int,
    batch: int,
    seq: int,
    workdir: str,
    schedule: str = "wsd",
    ckpt_every: int = 10,
    resume_job: bool = True,
    token: CancellationToken | None = None,
    device: str = "cuda",
    lr: float = 1e-3,
    layers: Optional[int] = None,
    on_step: Optional[Callable[[int, float], None]] = None,
) -> dict:
    """Claim (or resume) a training job and run it to ``steps``.

    ``lr`` is AdamW's peak rate (the reference's 1e-3 by default).
    ``layers`` cuts the model's depth (full width kept).  ``on_step(step,
    loss)`` is called after each step's progress report, before the next
    poll of ``token``.  Returns the reference's keys plus ``state`` (the
    final TrainState), ``save_s`` (the emergency checkpoint's seconds, on
    suspension) and ``restore_s`` (on resume).
    """
    dev = backend_mod.load(device).device  # explicit device init
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)

    jobs = JobStore(os.path.join(workdir, "jobs.db"))
    try:
        orphans = jobs.recover_orphans()
        if orphans:
            print(f"recovered orphaned jobs: {orphans}")

        job = jobs.claim_next(kind="train") if resume_job else None
        if job is None:
            jid = jobs.enqueue("train", {
                "arch": arch, "steps": steps, "batch": batch, "seq": seq,
                "lr": lr, "layers": layers, "device": device,
            })
            job = jobs.claim(jid)
            if job is None:
                raise RuntimeError(f"job {jid} was claimed by another "
                                   f"launcher")
        start_step = job.step
        print(f"job {job.job_id}: starting at step {start_step}/{steps}")

        store = CheckpointStore(os.path.join(workdir, "ckpt"))
        ckpt = AsyncCheckpointer(store)
        token = token or CancellationToken()

        sched = make_schedule(schedule, steps)
        train_step = make_train_step(cfg, AdamWConfig(lr=lr), sched)

        seed = stable_seed(arch)
        state = init_train_state(seed, cfg, device=dev)
        result: dict = {}
        latest = store.latest_step()
        if start_step > 0 and latest is not None:
            t0 = time.time()
            state = restore_train_state(store, latest, state)
            result["restore_s"] = time.time() - t0
            print(f"restored checkpoint step {latest}")

        wd = StepWatchdog(
            lambda el, med: print(f"straggler: step {el:.2f}s vs median "
                                  f"{med:.2f}s"),
            factor=10.0,
        )
        losses = []
        final_state = JobState.SUCCEEDED
        with PreemptionGuard(token), HoldAlive(jobs, job.job_id), wd:
            step = start_step
            while step < steps:
                # the paper's contract: flag polled between kernel executions
                if token.cancelled():
                    final_state = JobState.SUSPENDED
                    break
                wd.step_begin()
                batch_data = make_train_batch(
                    step_generator(seed, step, dev), cfg, batch, seq)
                state, metrics = train_step(state, batch_data)
                loss = float(metrics["loss"])   # waits for the step
                wd.step_end()
                step += 1
                losses.append(loss)
                jobs.report_progress(job.job_id, step=step, loss=loss)
                if step % ckpt_every == 0 or step == steps:
                    ckpt.submit(step, state, metadata={"arch": cfg.name,
                                                       "loss": loss})
                    jobs.report_progress(
                        job.job_id,
                        checkpoint_path=os.path.join(store.root,
                                                     f"step_{step}"),
                    )
                if on_step is not None:
                    on_step(step, loss)

            ckpt.wait()
            if final_state == JobState.SUSPENDED:
                t0 = time.time()
                path = emergency_save(store, step, state, token.reason.value)
                result["save_s"] = time.time() - t0
                jobs.report_progress(job.job_id, step=step,
                                     checkpoint_path=path)
                print(f"suspended at step {step}; emergency checkpoint: "
                      f"{path}")
            jobs.transition(job.job_id, final_state)
    finally:
        jobs.close()

    result.update({
        "job_id": job.job_id,
        "final_state": final_state.value,
        "steps_done": step,
        "losses": losses,
        "stragglers": wd.straggler_events,
        "state": state,
    })
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (full width)")
    ap.add_argument("--workdir", default=None,
                    help="job store and checkpoints (default: a new "
                         "directory under TMPDIR)")
    ap.add_argument("--schedule", default="wsd")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = run_training_job(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        batch=args.batch, seq=args.seq,
        workdir=args.workdir or tempfile.mkdtemp(prefix="repro_train_"),
        schedule=args.schedule, ckpt_every=args.ckpt_every,
        device=args.device, lr=args.lr, layers=args.layers,
    )
    first = out["losses"][0] if out["losses"] else float("nan")
    last = out["losses"][-1] if out["losses"] else float("nan")
    print(f"done: {out['final_state']} steps={out['steps_done']} "
          f"loss {first:.4f} -> {last:.4f}")


if __name__ == "__main__":
    main()
