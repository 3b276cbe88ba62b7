"""The port stands alone: a CPU mining job in a fresh interpreter loads
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
