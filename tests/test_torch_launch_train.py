"""The training launcher's lifecycle on the host (``device="cpu"``): twins
of the reference's ``tests/test_launch.py`` train tests, and the two
training examples at smoke size.

The preemption comes after a given step (``on_step``), not from a timer,
and the resume runs in a fresh interpreter: with the launcher's stable seed
its losses equal an uninterrupted run's bit for bit on the CPU.
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.cancellation import CancellationToken, CancelReason
from repro_torch.core.jobs import JobState, JobStore
from repro_torch.examples import preemption_resume, train_lm
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import restore_train_state, run_training_job
from repro_torch.tree import tree_leaves

SRC = Path(__file__).resolve().parents[1] / "src"
JOB = dict(arch="olmo-1b", smoke=True, batch=2, seq=32, device="cpu")


def _cancel_after(token, k):
    def on_step(step, _loss):
        if step == k:
            token.cancel(CancelReason.PREEMPTION)
    return on_step


def test_train_job_completes(tmp_path):
    out = run_training_job(steps=6, workdir=str(tmp_path), ckpt_every=3,
                           **JOB)
    assert out["final_state"] == "SUCCEEDED"
    assert out["steps_done"] == 6
    assert all(np.isfinite(v) for v in out["losses"])
    store = CheckpointStore(str(tmp_path / "ckpt"))
    assert store.latest_step() == 6
    assert store.steps() == [3, 6]
    assert int(out["state"].step) == 6
    job = JobStore(str(tmp_path / "jobs.db")).list_jobs()[0]
    assert job.state == JobState.SUCCEEDED and job.step == 6


_RESUME = """
import json, sys, torch
torch.set_num_threads({threads})
sys.path.insert(0, {src!r})
from repro_torch.launch.train import run_training_job
out = run_training_job(arch="olmo-1b", smoke=True, batch=2, seq=32,
                       device="cpu", steps={steps}, workdir={work!r},
                       ckpt_every=2)
print("RESULT", json.dumps({{k: out[k] for k in
                             ("final_state", "steps_done", "losses")}}))
"""


def test_train_preempt_then_resume_in_a_fresh_process(tmp_path):
    """The paper's core lifecycle: suspend after step 3, resume to
    completion in another interpreter, on the uninterrupted losses."""
    steps = 7
    ref = run_training_job(steps=steps, workdir=str(tmp_path / "ref"),
                           ckpt_every=100, **JOB)
    work = str(tmp_path / "run")
    tok = CancellationToken()
    out1 = run_training_job(steps=steps, workdir=work, ckpt_every=2,
                            token=tok, on_step=_cancel_after(tok, 3), **JOB)
    assert out1["final_state"] == "SUSPENDED"
    assert out1["steps_done"] == 3
    assert out1["save_s"] > 0
    jobs = JobStore(os.path.join(work, "jobs.db"))
    sus = jobs.list_jobs(JobState.SUSPENDED)
    assert len(sus) == 1 and sus[0].step == 3
    jobs.close()
    store = CheckpointStore(os.path.join(work, "ckpt"))
    assert store.latest_step() == 3
    assert store.manifest(3)["metadata"] == {"emergency": True,
                                             "reason": "preemption"}
    # the emergency checkpoint holds the suspended state bit for bit
    back = restore_train_state(store, 3, out1["state"])
    for a, b in zip(tree_leaves(out1["state"]._asdict()),
                    tree_leaves(back._asdict())):
        assert torch.equal(a.detach(), b.detach())

    script = _RESUME.format(threads=torch.get_num_threads(), src=str(SRC),
                            steps=steps, work=work)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    out2 = json.loads(line[len("RESULT "):])
    assert out2["final_state"] == "SUCCEEDED"
    assert out2["steps_done"] == steps
    assert "restored checkpoint step 3" in proc.stdout
    assert out1["losses"] + out2["losses"] == ref["losses"]
    jobs = JobStore(os.path.join(work, "jobs.db"))
    assert [j.state for j in jobs.list_jobs()] == [JobState.SUCCEEDED]
    jobs.close()


def test_a_fresh_job_ignores_resume_when_asked(tmp_path):
    tok = CancellationToken()
    run_training_job(steps=4, workdir=str(tmp_path), token=tok,
                     on_step=_cancel_after(tok, 1), **JOB)
    out = run_training_job(steps=2, workdir=str(tmp_path), resume_job=False,
                           **JOB)
    assert out["final_state"] == "SUCCEEDED" and out["job_id"] == 2
    jobs = JobStore(str(tmp_path / "jobs.db"))
    assert [j.state for j in jobs.list_jobs()] == [JobState.SUSPENDED,
                                                   JobState.SUCCEEDED]
    jobs.close()


def test_stable_seed_is_the_same_in_every_process():
    assert launch_train.stable_seed("olmo-1b") == \
        zlib.crc32(b"olmo-1b") % 2**31
    code = ("import sys; sys.path.insert(0, %r); from repro_torch.launch."
            "train import stable_seed; print(stable_seed('olmo-1b'))"
            % str(SRC))
    for hashseed in ("1", "2"):
        out = subprocess.run([sys.executable, "-c", code], text=True,
                             capture_output=True, timeout=60,
                             env=dict(os.environ, PYTHONHASHSEED=hashseed))
        assert int(out.stdout) == launch_train.stable_seed("olmo-1b")


def test_cli_runs_a_smoke_job(tmp_path, capsys):
    launch_train.main(["--arch", "glm4-9b", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--workdir", str(tmp_path), "--layers", "1"])
    out = capsys.readouterr().out
    assert "done: SUCCEEDED steps=3" in out
    params = JobStore(str(tmp_path / "jobs.db")).list_jobs()[0].params
    assert params["layers"] == 1 and params["device"] == "cpu"


def test_example_train_lm(tmp_path, capsys):
    out = train_lm.main(["--steps", "12", "--batch", "2", "--seq", "16",
                         "--device", "cpu", "--workdir", str(tmp_path)])
    assert out["final_state"] == "SUCCEEDED" and out["steps_done"] == 12
    assert "final: SUCCEEDED after 12 steps" in capsys.readouterr().out


def test_example_preemption_resume(tmp_path, capsys):
    out1, out2 = preemption_resume.main(["--steps", "6", "--preempt-after",
                                         "2", "--device", "cpu",
                                         "--workdir", str(tmp_path)])
    assert out1["final_state"] == "SUSPENDED" and out1["steps_done"] == 2
    assert out2["final_state"] == "SUCCEEDED" and out2["steps_done"] == 6
    assert "resume path verified" in capsys.readouterr().out
