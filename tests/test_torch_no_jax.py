"""The port stands alone: a CPU mining job, a CPU service round trip, a
CPU LM serving batch, the durable serving tier's modules (replication,
the fleet and its worker entry point), the distributed lane (a ring
degree on a mesh of two host shards, the elastic restore) and LM training
(a two-step CPU training job; the optimizer, the token pipeline and the
training examples) and the four tour examples in a fresh interpreter load
neither jax nor anything of the reference package."""

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import sys, tempfile
import repro_torch
from repro_torch.launch.mine import run_mining_job
for algo in ("kmeans", "dbscan"):
    out = run_mining_job(algo=algo, features=2, clusters=3, size=64,
                         workdir=tempfile.mkdtemp(), device="cpu")
    assert out["final_state"] == "SUCCEEDED", out
import numpy as np
import repro_torch.service
from repro_torch.launch import serve_mine
work = serve_mine.build_workload(2, 1, "mixed", points=16)
with repro_torch.service.MiningClient(tempfile.mkdtemp(), device="cpu",
                                      max_wait_s=0.001) as client:
    results = []
    failures = serve_mine.drive(client, work, rate=0, executor="cuda-kernel",
                                results=results)
assert failures == {"suspended": 0, "dropped": 0, "rejected": 0}, failures
assert [r["algo"] for r in results] == ["dbscan", "kmeans"], results
from repro_torch.launch import serve
out = serve.serve_batch(arch="olmo-1b", smoke=True, batch=2, prompt_len=6,
                        gen=3, device="cpu")
assert tuple(out["generated"].shape) == (2, 3), out
import repro_torch.service.replicate
import repro_torch.service.fleet
import repro_torch.service.fleet.worker
assert repro_torch.service.fleet.worker.FleetWorker
import torch
from repro_torch.core import distributed
from repro_torch.checkpoint import elastic
mesh = distributed.Mesh(("cpu", "cpu"))
assert distributed.ring_degree(mesh, torch.zeros(5, 2), 1.0).tolist() == [5] * 5
assert elastic.restore_resharded
import repro_torch.train, repro_torch.optim, repro_torch.data.tokens
import repro_torch.optim.compress, repro_torch.runtime.watchdog
import repro_torch.examples.train_lm, repro_torch.examples.preemption_resume
import repro_torch.examples.quickstart, repro_torch.examples.mine_cluster
import repro_torch.examples.service_demo
import repro_torch.examples.embedding_clustering
from repro_torch.launch.train import run_training_job
out = run_training_job(arch="olmo-1b", smoke=True, steps=2, batch=2, seq=8,
                       workdir=tempfile.mkdtemp(), device="cpu")
assert out["final_state"] == "SUCCEEDED", out
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
print("FORBIDDEN", bad)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
