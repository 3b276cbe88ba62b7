"""Multi-pod dry-run: every (arch x shape x mesh) cell, on the meta device.

The counterpart of the reference's ``repro/launch/dryrun.py``, which
compiles each cell for 512 forced host devices and reads XLA's analyses.
The port needs no device either: it resolves each cell's layouts on an
abstract mesh and runs its step on meta tensors (``launch/cells.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k [--multi-pod]

Per cell it writes results/dryrun_torch/<mesh>/<arch>__<shape>.json with
the reference's keys where they mean the same:

- ``memory_analysis``: per device, ``argument_size_in_bytes`` (exact, from
  the layouts; the train state's host-side generator state left out),
  ``output_size_in_bytes`` and ``alias_size_in_bytes`` (the outputs, and
  those updated in place: the train state, the decode cache), and
  ``temp_size_in_bytes`` (the peak of the step's temporaries at one
  device's batch, ``temp_is_upper_bound`` where the mesh shards other
  dims too, which the trace keeps whole);
- ``cost_analysis.flops``: the step's FLOPs at full depth, matrix products
  only (``FlopCounterMode``; the kernels' shape ops count their own work);
  XLA also counts element-wise work, so the two do not compare one to one;
- ``collectives``: the modelled collectives (``launch/hlo.py:
  model_collectives``), a model of the schedule, not a compiler's;
- ``derived``: the totals at full depth, from traces at depth ``period``
  and 2 ``period`` (``analysis_depth1`` / ``analysis_depth2``), as the
  reference derives them (:func:`_derive_totals`);
- ``n_params``, ``n_active_params``, ``n_groups``, ``local_batch``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES, cell_applicable
from repro_torch.launch import cells
from repro_torch.launch.hlo import model_collectives
from repro_torch.launch.mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def mesh_name(multi_pod: bool) -> str:
    return "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"


def mesh_label(mesh) -> str:
    """The production meshes' names, else ``mesh_<sizes>``."""
    for multi_pod in (False, True):
        if mesh == make_production_mesh(multi_pod=multi_pod):
            return mesh_name(multi_pod)
    return "mesh_" + "x".join(str(s) for s in mesh.sizes)


def _derive_totals(f1: dict, f2: dict, n_groups: int, kind: str) -> dict:
    """Totals at full depth from traces at one and two periods.

    FLOPs: f1 + (G-1) (f2 - f1), as the reference derives them.  The temp
    peak of a train step grows with the activations each group keeps for
    the backward pass, so it is derived the same way; a prefill or decode
    step keeps nothing of a group but its successor's input, so its peak
    at full depth is the two-period trace's (``tests/test_torch_dryrun.py``
    holds both to full-depth traces).
    """
    g = n_groups

    def lin(a, b):
        return a + (g - 1) * (b - a)

    temp = (lin(f1["temp_size_in_bytes"], f2["temp_size_in_bytes"])
            if kind == "train" else f2["temp_size_in_bytes"])
    return {"flops": lin(f1["flops"], f2["flops"]),
            "temp_size_in_bytes": int(temp)}


def cell_collectives(cell: cells.Cell) -> dict:
    """The modelled collectives of ``cell``'s step at full depth."""
    cfg, mesh, rules = cell.cfg, cell.mesh, cell.rules
    if cell.kind == "train":
        state, state_specs = cell.args[0], cell.specs[0]
        return model_collectives(
            cfg, "train", mesh, rules, cell.local_batch, cell.shape.seq_len,
            state.params, state_specs.params, state_specs.opt["mu"])
    cache_specs = cell.specs[1] if cell.kind == "decode" else None
    return model_collectives(cfg, cell.kind, mesh, rules, cell.local_batch,
                             cell.shape.seq_len, cell.args[0], cell.specs[0],
                             cache_specs=cache_specs)


def run_cell(arch: str, shape, multi_pod: bool, rule_overrides=None,
             cfg_overrides=None, tag: str = "", mesh=None) -> dict:
    """One cell's record: ``shape`` a name of ``SHAPES`` (or a ShapeSpec),
    ``mesh`` an abstract mesh in place of the production one."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    cell = cells.build_cell(arch, shape, mesh, rule_overrides, cfg_overrides)
    cfg = cell.cfg
    t0 = time.perf_counter()
    f1 = cells.trace_cell(cell, n_layers=cfg.period)
    f2 = (f1 if cfg.n_groups == 1
          else cells.trace_cell(cell, n_layers=2 * cfg.period))
    derived = _derive_totals(f1, f2, cfg.n_groups, cell.kind)
    seconds = time.perf_counter() - t0
    coll = cell_collectives(cell)
    out_bytes, alias = cells.output_bytes(cell)
    derived.update(
        wire_bytes=coll["total_wire_bytes"],
        per_op_wire_bytes={k: v["wire_bytes"]
                           for k, v in coll["per_op"].items()})
    return {
        "arch": arch,
        "shape": cell.shape.name,
        "mesh": mesh_label(mesh),
        "devices": mesh.size,
        "tag": tag,
        "status": "ok",
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "n_groups": cfg.n_groups,
        "local_batch": cell.local_batch,
        "seconds_trace": seconds,
        "memory_analysis": {
            "argument_size_in_bytes": cells.argument_bytes(cell),
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": derived["temp_size_in_bytes"],
            "temp_is_upper_bound": cells.temp_is_upper_bound(cell),
        },
        "cost_analysis": {"flops": derived["flops"]},
        "collectives": coll,
        "analysis_depth1": f1,
        "analysis_depth2": f2,
        "derived": derived,
    }


def save_result(result: dict, out_dir: str) -> str:
    mesh_dir = os.path.join(out_dir, result["mesh"])
    os.makedirs(mesh_dir, exist_ok=True)
    tag = f"__{result['tag']}" if result.get("tag") else ""
    path = os.path.join(
        mesh_dir, f"{result['arch']}__{result['shape']}{tag}.json"
    )
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path


def iter_cells():
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_applicable(cfg, shape)
            yield arch, shape.name, ok, why


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = [args.multi_pod]
    if args.both_meshes or args.all:
        meshes = [False, True]

    if args.all:
        todo = [(a, s) for a, s, ok, _ in iter_cells() if ok]
        for a, s, ok, why in iter_cells():
            if not ok:
                print(f"SKIP {a} x {s}: {why}", flush=True)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    failures = []
    t_all = time.perf_counter()
    for multi_pod in meshes:
        name = mesh_name(multi_pod)
        for arch, shape in todo:
            out_path = os.path.join(args.out, name, f"{arch}__{shape}.json")
            if args.skip_existing and os.path.exists(out_path):
                print(f"SKIP(existing) {arch} x {shape} [{name}]", flush=True)
                continue
            label = f"{arch} x {shape} [{name}]"
            try:
                result = run_cell(arch, shape, multi_pod)
                path = save_result(result, args.out)
                mem = result["memory_analysis"]
                print(
                    f"OK   {label}: trace={result['seconds_trace']:.2f}s "
                    f"flops={result['derived']['flops']:.3e} "
                    f"args={mem['argument_size_in_bytes'] / 1e9:.3f}GB "
                    f"temp={mem['temp_size_in_bytes'] / 1e9:.3f}GB"
                    f"{' (upper bound)' if mem['temp_is_upper_bound'] else ''}"
                    f" wire={result['collectives']['total_wire_bytes']:.3e}B"
                    f" -> {os.path.relpath(path)}",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 - one cell's failure is recorded
                failures.append((label, repr(e)))
                os.makedirs(os.path.join(args.out, name), exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump({
                        "arch": arch, "shape": shape, "mesh": name,
                        "status": "fail", "error": traceback.format_exc(),
                    }, f, indent=2)
                print(f"FAIL {label}: {e!r}", flush=True)

    print(f"\n{len(todo) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed, {time.perf_counter() - t_all:.1f} s")
    if failures:
        for label, err in failures:
            print(f"  FAILED: {label}: {err[:200]}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
