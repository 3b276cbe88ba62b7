"""The port's one-job app (the reference's tests/test_launch.py mining
cases), run on the CPU."""

import subprocess
import sys

import pytest
import torch

from repro_torch.core.cancellation import CancellationToken
from repro_torch.core.jobs import JobState, JobStore
from repro_torch.launch.mine import run_mining_job


@pytest.mark.parametrize("algo", ["kmeans", "dbscan"])
def test_mine_job_succeeds_on_cpu(tmp_path, algo):
    out = run_mining_job(algo=algo, features=2, clusters=4, size=128,
                         workdir=str(tmp_path), device="cpu")
    assert out["final_state"] == "SUCCEEDED" and not out["cancelled"]
    assert out["device"] == "cpu"
    assert out["labels"].shape == (512,) and out["labels"].dtype == torch.int16
    if algo == "kmeans":
        assert out["iterations"] >= 1 and out["inertia"] > 0
    else:
        assert out["n_clusters"] >= 1 and out["expansions"] >= 1
    jobs = JobStore(str(tmp_path / "jobs.db"))
    (job,) = jobs.list_jobs()
    assert job.state == JobState.SUCCEEDED and job.params["device"] == "cpu"
    jobs.close()


def test_pre_cancelled_job_is_suspended(tmp_path):
    tok = CancellationToken()
    tok.cancel()
    out = run_mining_job(algo="dbscan", features=2, clusters=4, size=128,
                         workdir=str(tmp_path), token=tok, device="cpu")
    assert out["final_state"] == "SUSPENDED"
    assert out["cancelled"]


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mining_job(algo="kmeans", features=2, clusters=4, size=128,
                       workdir=str(tmp_path))
    assert not (tmp_path / "jobs.db").exists()  # nothing ran on the host


def test_cli_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--algo", "kmeans",
         "--features", "1", "--clusters", "2", "--size", "64",
         "--workdir", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'final_state': 'SUCCEEDED'" in proc.stdout
