"""No module a run imports has the top-level name jax, jaxlib, flax or
repro; the reference imports nothing of repro_torch."""

import json
import subprocess
import sys

from portbench.tests.sizes import ROOT

PRELUDE = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
"""


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PRELUDE + code + """
import json
print(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))
"""], capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_repro():
    tops = _tops("""
from portbench.tests.sizes import small_config
from portbench import readings, run
for cell, config in (("kmeans-d4.fit", "kmeans-d4"),
                     ("dbscan-d4.fit", "dbscan-d4")):
    run.run_cell(cell, 5, 0.1, True, device="cpu",
                 config=small_config(config))
assert not run.forbidden_modules(), run.forbidden_modules()
""")
    assert "repro_torch" in tops          # the run drove the port
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    tops = _tops("""
import torch
from portbench import checks
from portbench.reference import dbscan, kmeans
x = torch.rand((300, 3))
dbscan.fit(x, 0.3, 4)
dbscan.fit(x, 0.3, 4, "tf32")
kmeans.lloyd(x, x[:5].clone(), 3)
kmeans.lloyd(x, x[:5].clone(), 3, "tf32")
""")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
