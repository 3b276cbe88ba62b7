"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell once (``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``) and prints one JSON line.
Everything a cell is made of is found by name:

- the cell (configuration, traffic, chips) in ``BENCHMARK.json`` at the
  root of the checkout;
- the configuration in ``portbench/configs/<config>.json``, and the
  generator of its inputs (its ``data.generator``) in
  ``portbench/generators/<generator>.py``;
- the traffic mix in ``portbench/traffic/<traffic>.json``, which names
  the entry its jobs go through, driven by ``portbench/entries/<entry>.py``
  (:mod:`portbench.drive`);
- the sample and limits of its correctness check in
  ``portbench/cells/<cell>.json``, and the configuration's algorithm's
  comparison, control and host-sized copy in
  ``portbench/checks/<algorithm>.py``;
- each per-layer metric's reader in ``portbench/metrics/<metric>.py``.

The yardstick stays here: the generators (:mod:`portbench.inputs`), the
work counts and peaks (:mod:`portbench.work`), the trace reduction
(:mod:`portbench.tracing`), the plain reference
(:mod:`portbench.reference`) and the comparisons (:mod:`portbench.checks`).
Nothing here imports ``jax`` or the JAX package ``repro``; the reference
imports nothing of ``repro_torch`` either.
"""
