"""Collective inventories for the roofline's third term.

Two sources, one form (``{"per_op": {op: {count, result_bytes,
wire_bytes}}, "total_wire_bytes"}``):

- :func:`analyze_collectives` parses an optimized HLO dump, as the
  reference's ``repro/launch/hlo.py`` does (copied verbatim with
  :func:`wire_bytes`): every all-reduce / all-gather / reduce-scatter /
  all-to-all / collective-permute instruction, its result bytes and its
  participant-group size, converted to per-device wire bytes with the
  ring-algorithm factors;
- :func:`model_collectives` is what the port's dry-run records: a **model
  of the schedule** derived from the resolved layouts of a cell (the port
  runs on the meta device and has no compiler whose schedule it could
  read).  It is not a compiler's schedule.  It counts, per device:

  * train cells, leaf by leaf over the data axes: the gradient all-reduce,
    or with ZeRO-1 (the optimizer state sharded over the data axes) a
    reduce-scatter of the gradient and an all-gather of the updated
    parameter, or with ZeRO-3 two all-gathers of the parameter (forward,
    backward) and a reduce-scatter of the gradient;
  * train and prefill cells, where the rules shard ``seq_sp`` over
    ``model`` (Megatron sequence parallelism): an all-gather of the
    (B_local, S, E) stream into every mixer and dense-FFN sub-layer and a
    reduce-scatter out of it;
  * decode cells: an all-reduce of the (B_local, 1, E) output of every
    mixer and dense-FFN sub-layer over ``model`` (tensor parallelism), and
    of each attention sub-layer's (B_local, 1, H, D) float32 output over
    the axes that shard the KV cache's sequence (flash-decode);
  * an all-to-all to dispatch and one to combine the tokens of every MoE
    sub-layer whose experts shard, sized by the dispatch buffer;

  a train cell counts the forward's collectives again for the backward
  pass, and once more where ``cfg.remat`` recomputes the forward.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, Iterable, Tuple

from repro_torch.models.moe import grouping
from repro_torch.parallel.resolve import map_tree
from repro_torch.parallel.sharding import _axes_size, _filter_axes, local_shape
from repro_torch.tree import tree_leaves

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4,
    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g.  %all-gather.3 = bf16[16,4096,128]{2,1,0} all-gather(...)
_INSTR_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(",
)

_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_SRC_TGT_RE = re.compile(r"source_target_pairs=\{")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _tuple_bytes(inner: str) -> int:
    # tuple result: "(f32[128]{0}, f32[128]{0})"
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", inner):
        total += _shape_bytes(m.group(1), m.group(2))
    return total


def _group_size(line: str, total_devices: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        # replica_groups=[num_groups, group_size]<=[...]
        return max(1, int(m.group(2)))
    m = _GROUPS_BRACE_RE.search(line)
    if m:
        first = m.group(1).strip()
        if first:
            return len(first.split(","))
    if _SRC_TGT_RE.search(line):
        return 2  # permute: pairwise
    return total_devices


def wire_bytes(op: str, result_bytes: int, group: int) -> float:
    """Per-device bytes on the wire, ring-algorithm convention."""
    g = max(group, 1)
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)   # input = result * g
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    if op == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)


def analyze_collectives(hlo_text: str, total_devices: int) -> Dict:
    """Returns {'ops': [...], 'per_op': {op: {count, result_bytes,
    wire_bytes}}, 'total_wire_bytes': float}."""
    per_op: Dict[str, Dict] = defaultdict(
        lambda: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
    )
    seen_done = set()
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        # async pairs: count the -start, skip the -done
        if "-done(" in line:
            continue
        tuple_inner, dtype, dims, op = m.groups()
        if tuple_inner is not None:
            rb = _tuple_bytes(tuple_inner)
        else:
            rb = _shape_bytes(dtype, dims)
        g = _group_size(line, total_devices)
        w = wire_bytes(op, rb, g)
        ent = per_op[op]
        ent["count"] += 1
        ent["result_bytes"] += rb
        ent["wire_bytes"] += w
    total = sum(e["wire_bytes"] for e in per_op.values())
    return {
        "per_op": dict(per_op),
        "total_wire_bytes": total,
    }


# ---------------------------------------------------------------------------
# The port's collective model
# ---------------------------------------------------------------------------

# (op, result bytes per device, group size, count)
Collective = Tuple[str, int, int, int]


def inventory(collectives: Iterable[Collective]) -> Dict:
    """:func:`analyze_collectives`' form from modelled collectives; groups
    of one device move nothing and are left out."""
    per_op: Dict[str, Dict] = {}
    for op, rb, group, count in collectives:
        if group <= 1 or count <= 0:
            continue
        ent = per_op.setdefault(op, {"count": 0, "result_bytes": 0,
                                     "wire_bytes": 0.0})
        ent["count"] += count
        ent["result_bytes"] += rb * count
        ent["wire_bytes"] += wire_bytes(op, rb, group) * count
    return {
        "per_op": per_op,
        "total_wire_bytes": sum(e["wire_bytes"] for e in per_op.values()),
        "source": "model of the schedule from the resolved layouts "
                  "(launch/hlo.py:model_collectives), not a compiler's",
    }


def _sharded_by(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec)


def _local_bytes(spec, t, mesh) -> int:
    return math.prod(local_shape(spec, tuple(t.shape), mesh)) * t.itemsize


def model_collectives(cfg, kind: str, mesh, rules, local_batch: int,
                      seq: int, params, param_specs, opt_specs=None,
                      cache_specs=None) -> Dict:
    """The modelled collectives of one step of a cell (see the module
    docstring), per device, in :func:`inventory`'s form.

    ``params`` / ``param_specs``: the params tree (tensors of the global
    shapes, meta or real) and its layouts; ``opt_specs``: the layouts of
    the optimizer moments (train cells); ``cache_specs``: the decode
    cache's (decode cells).
    """
    daxes = _filter_axes(mesh, ("pod", "data"))
    dp = _axes_size(mesh, daxes)
    tp = _axes_size(mesh, _filter_axes(mesh, "model"))
    act = 2 if cfg.dtype == "bfloat16" else 4
    out = []

    passes = 1
    if kind == "train":
        passes = 2 + (cfg.remat != "none")
        for t, ps, os in tree_leaves(map_tree(lambda *a: a, params,
                                              param_specs, opt_specs)):
            lb = _local_bytes(ps, t, mesh)
            if _sharded_by(ps, "data") or _sharded_by(ps, "pod"):
                # ZeRO-3: gathered for the forward and the backward
                out.append(("all-gather", lb * dp, dp, 2))
                out.append(("reduce-scatter", lb, dp, 1))
            elif _sharded_by(os, "data") or _sharded_by(os, "pod"):
                out.append(("reduce-scatter", lb // dp, dp, 1))   # ZeRO-1
                out.append(("all-gather", lb, dp, 1))
            else:
                out.append(("all-reduce", lb, dp, 1))

    moe_ep = any(_sharded_by(sub["moe"]["w_up"], "model")
                 for sub in param_specs["layers"].values() if "moe" in sub)
    tokens = 1 if kind == "decode" else seq
    regions = moe_layers = attn_layers = 0
    for mixer, ff in cfg.pattern:
        regions += 1
        attn_layers += mixer == "attn"
        if ff == "moe" and moe_ep:
            moe_layers += 1
        elif ff is not None:
            regions += 1
    regions *= cfg.n_groups
    moe_layers *= cfg.n_groups
    attn_layers *= cfg.n_groups
    stream = local_batch * tokens * cfg.d_model * act

    if kind in ("train", "prefill") and rules.get("seq_sp") == "model":
        # sequence parallelism: the stream gathered into each region and
        # reduce-scattered out of it
        out.append(("all-gather", stream, tp, regions * passes))
        out.append(("reduce-scatter", stream // tp, tp, regions * passes))
    if kind == "decode":
        out.append(("all-reduce", stream, tp, regions))
        k_specs = [sub["k"] for sub in cache_specs.values() if "k" in sub]
        # stacked (groups, B, S, KV, D): dim 2 is the sequence
        if k_specs and len(k_specs[0]) > 2 and k_specs[0][2] is not None:
            heads = local_batch * cfg.n_heads_padded * cfg.d_head * 4
            out.append(("all-reduce", heads, _axes_size(mesh, k_specs[0][2]),
                        attn_layers))
    if moe_layers:
        group, cap = grouping(cfg, tokens, no_drop=kind == "decode")
        buf = (local_batch * (tokens // group) * cfg.n_experts * cap
               * cfg.d_model * act)
        out.append(("all-to-all", buf // tp, tp, 2 * moe_layers * passes))
    return inventory(out)
