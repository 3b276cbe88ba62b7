"""Dry-run cell construction: (arch x shape x mesh) -> a step on the meta
device.

The counterpart of the reference's ``repro/launch/cells.py``, shared by
``launch/dryrun.py``.  :func:`build_cell` resolves the cell's layouts
(:class:`repro_torch.parallel.sharding.Spec` trees) over its abstract mesh
and holds its arguments as meta tensors of the global shapes: nothing is
allocated for the full configs.  In place of the reference's
``lower_cell`` (jit + lower + XLA's analyses), :func:`trace_cell` runs the
cell's step once on the meta device at one device's batch and counts:

- FLOPs, by ``torch.utils.flop_counter.FlopCounterMode``.  It counts the
  matrix products (``mm``, ``bmm``, the attention einsums, and the flash
  kernel's shape op at 4 D operations per scored pair), recomputed
  products included; element-wise passes (the Mamba scan's, the MoE
  gathers, norms, softmax) are not counted, where XLA's ``cost_analysis``
  counts them;
- the peak of temporaries: the bytes of every storage an op of the step
  creates, live from its creation until it is freed (a weakref finalizer
  on the storage); the arguments' storages, and the storages the step
  returns, are left out, as XLA's ``temp_size_in_bytes`` leaves them out.

The trace runs at the cell's local batch (the global batch over the mesh
axes its layout shards it on, at least 1).  Dims sharded over ``model`` or
a cache's sequence axes are not divided, so on such a mesh the temp figure
is an upper bound of one device's (``temp_is_upper_bound``) and the FLOPs
are those of the whole data shard.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import (
    ModelConfig,
    ShapeSpec,
    cell_applicable,
    shape_by_name,
)
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import resolve
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    ShardingRules,
    local_shape,
    spec_for_shape,
)
from repro_torch.train.step import (
    abstract_train_state,
    as_trainable,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    train_batch_shapes,
    train_state_axes,
)


def rules_for(cfg: ModelConfig, shape: ShapeSpec,
              overrides: Optional[Dict[str, Any]] = None,
              tp: int = 16) -> ShardingRules:
    """Per-shape rule adjustments (the reference's deployable policy).

    - train/prefill: Megatron sequence parallelism — the residual stream
      between sub-layers shards over 'model' (seq_sp), dividing layer-
      boundary activation saves by TP;
    - decode, GQA archs (kv_heads % TP != 0): the KV cache shards over the
      *sequence* dim on 'model' (flash-decode style) instead of replicating
      2-8 KV heads per chip;
    - decode, batch < data axis (long_500k batch=1): the sequence dim also
      takes the idle 'data' axis.
    """
    rules = DEFAULT_RULES
    if shape.kind in ("train", "prefill"):
        rules = rules.override(seq_sp="model")
    if shape.kind == "decode":
        kv_shardable = (
            cfg.n_kv_heads_padded and cfg.n_kv_heads_padded % tp == 0
        )
        seq_axes = [] if kv_shardable else ["model"]
        if shape.global_batch < 16:
            seq_axes = ["data"] + seq_axes
            rules = rules.override(batch=("pod",))
        if seq_axes:
            rules = rules.override(seq_kv=tuple(seq_axes))
    if overrides:
        rules = rules.override(**overrides)
    return rules


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    mesh: Any                 # an AbstractMesh
    args: Tuple[Any, ...]     # meta trees of the global shapes (and pos)
    specs: Tuple[Any, ...]    # their Spec trees (None for a Python int)
    rules: ShardingRules
    local_batch: int          # the batch one device steps

    @property
    def kind(self) -> str:
        return self.shape.kind


def _batch_specs(mesh, rules: ShardingRules, shapes: Dict[str, Any]):
    out = {}
    for name, t in shapes.items():
        axes = (("batch", "seq", "embed") if name == "prefix_embeds"
                else ("batch", "seq"))
        out[name] = spec_for_shape(rules, axes, mesh, tuple(t.shape))
    return out


def build_cell(
    arch: str,
    shape: Union[str, ShapeSpec],
    mesh,
    rule_overrides: Optional[Dict[str, Any]] = None,
    cfg_overrides: Optional[Dict[str, Any]] = None,
) -> Cell:
    """The cell of ``arch`` at ``shape`` (a name of ``SHAPES``, or a
    ShapeSpec) on ``mesh``."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if isinstance(shape, str):
        shape = shape_by_name(shape)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"inapplicable cell {arch}x{shape.name}: {why}")
    tp = mesh.shape.get("model", 1)
    rule_overrides = dict(rule_overrides or {})
    zero3 = rule_overrides.pop("_zero3", False)
    rules = rules_for(cfg, shape, rule_overrides, tp=tp)
    b, s = shape.global_batch, shape.seq_len

    params_abs = lm.abstract_params(cfg)
    param_specs = resolve.tree_specs(lm.param_axes(cfg), params_abs, mesh,
                                     rules)
    if zero3:
        # ZeRO-3: parameters also shard over the data axes (per-layer
        # all-gathers in the forward and backward)
        param_specs = resolve.zero_specs(param_specs, params_abs, mesh)

    if shape.kind == "train":
        state_abs = abstract_train_state(cfg)
        state_specs = resolve.train_state_shardings(
            train_state_axes(cfg), state_abs, mesh, rules, zero3=zero3)
        batch_abs = train_batch_shapes(cfg, b, s)
        args = (state_abs, batch_abs)
        specs = (state_specs, _batch_specs(mesh, rules, batch_abs))
    elif shape.kind == "prefill":
        batch_abs = train_batch_shapes(cfg, b, s)
        batch_abs.pop("labels")
        args = (params_abs, batch_abs)
        specs = (param_specs, _batch_specs(mesh, rules, batch_abs))
    else:
        cache_abs = lm.abstract_decode_cache(cfg, b, s)
        cache_specs = resolve.tree_specs(lm.cache_axes(cfg, b, s), cache_abs,
                                         mesh, rules)
        tok = torch.empty((b, 1), dtype=torch.int64, device="meta")
        # the last position: attention reads the whole cache, as the
        # reference's decode does under its mask
        args = (params_abs, cache_abs, tok, s - 1)
        specs = (param_specs, cache_specs,
                 spec_for_shape(rules, ("batch", "seq"), mesh, (b, 1)), None)
    tok_spec = specs[1]["tokens"] if shape.kind != "decode" else specs[2]
    local_batch = local_shape(tok_spec, (b, 1), mesh)[0]
    return Cell(arch=arch, shape=shape, cfg=cfg, mesh=mesh, args=args,
                specs=specs, rules=rules, local_batch=local_batch)


# ---------------------------------------------------------------------------
# Bytes per device, from the layouts
# ---------------------------------------------------------------------------


def _on_device(t: Any) -> bool:
    """A tensor the device holds (the train state's ``rng`` is a CPU
    generator's state, kept on the host)."""
    return isinstance(t, torch.Tensor) and t.device.type != "cpu"


def _leaf_pairs(arg: Any, spec: Any):
    """(leaf, its Spec) over trees of one structure (nested dicts and
    namedtuples)."""
    if isinstance(arg, dict):
        for k in sorted(arg):
            yield from _leaf_pairs(arg[k], spec[k])
    elif isinstance(arg, tuple) and hasattr(arg, "_fields"):
        for a, sp in zip(arg, spec):
            yield from _leaf_pairs(a, sp)
    else:
        yield arg, spec


def tree_bytes(args: Tuple[Any, ...], specs: Tuple[Any, ...], mesh) -> int:
    """Bytes of one device's shards of the tensors in ``args`` laid out by
    ``specs`` (trees of one structure); Python scalars and host tensors
    add nothing."""
    total = 0
    for arg, spec in zip(args, specs):
        for a, s in _leaf_pairs(arg, spec):
            if _on_device(a):
                total += (math.prod(local_shape(s, tuple(a.shape), mesh))
                          * a.itemsize)
    return total


def argument_bytes(cell: Cell) -> int:
    """Per-device argument bytes, exact from the layouts (the host-side
    ``rng`` and the decode position, a Python int, add nothing)."""
    return tree_bytes(cell.args, cell.specs, cell.mesh)


def output_bytes(cell: Cell) -> Tuple[int, int]:
    """(per-device output bytes, of which alias an argument).

    train: the state, updated in place (aliased), and 5 float32 metrics;
    prefill: the last position's float32 logits of the local batch and the
    new decode cache; decode: the logits and the cache, written in place
    (aliased).
    """
    logits = cell.local_batch * cell.cfg.vocab_padded * 4
    if cell.kind == "train":
        state = tree_bytes(cell.args[:1], cell.specs[:1], cell.mesh)
        return state + 5 * 4, state
    if cell.kind == "prefill":
        b, s = cell.shape.global_batch, cell.shape.seq_len
        cache_abs = lm.abstract_decode_cache(cell.cfg, b, s)
        cache_specs = resolve.tree_specs(lm.cache_axes(cell.cfg, b, s),
                                         cache_abs, cell.mesh, cell.rules)
        return logits + tree_bytes((cache_abs,), (cache_specs,),
                                   cell.mesh), 0
    cache = tree_bytes(cell.args[1:2], cell.specs[1:2], cell.mesh)
    return logits + cache, cache


# ---------------------------------------------------------------------------
# The meta trace
# ---------------------------------------------------------------------------


class LiveBytes(TorchDispatchMode):
    """Records when each storage an op creates comes to life and when it
    is freed (a weakref finalizer), with its bytes; storages in
    ``exclude`` (the arguments') are not recorded."""

    def __init__(self, exclude=()):
        super().__init__()
        self.exclude = set(exclude)
        self.ids: Dict[int, int] = {}    # live storage -> its record id
        self.events: list = []           # (record id, +bytes / -bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage())
        return out

    def _track(self, storage) -> None:
        key = storage._cdata
        if key in self.exclude or key in self.ids:
            return
        rid = len(self.events)
        nbytes = storage.nbytes()
        self.ids[key] = rid
        self.events.append((rid, nbytes))
        weakref.finalize(storage, self._release, key, rid, nbytes)

    def _release(self, key: int, rid: int, nbytes: int) -> None:
        del self.ids[key]
        self.events.append((rid, -nbytes))

    def peak(self, leave_out=()) -> int:
        """The largest sum of live bytes, the records in ``leave_out``
        left out."""
        cur = top = 0
        for rid, delta in self.events:
            if rid not in leave_out:
                cur += delta
                top = max(top, cur)
        return top


def _storages(tree: Any):
    for t in pytree_leaves(tree):
        if isinstance(t, torch.Tensor):
            yield t.untyped_storage()._cdata


def _local_args(cfg: ModelConfig, kind: str, local_batch: int, seq: int):
    """The step and its arguments at one device's batch, meta tensors (the
    train state's ``rng`` a real CPU generator state)."""
    if kind == "train":
        state = abstract_train_state(cfg)
        as_trainable(state.params)
        return (make_train_step(cfg, AdamWConfig()),
                (state, train_batch_shapes(cfg, local_batch, seq)))
    params = lm.abstract_params(cfg)
    if kind == "prefill":
        batch = train_batch_shapes(cfg, local_batch, seq)
        batch.pop("labels")
        return make_prefill_step(cfg, max_seq=seq), (params, batch)
    cache = lm.abstract_decode_cache(cfg, local_batch, seq)
    tok = torch.empty((local_batch, 1), dtype=torch.int64, device="meta")
    return make_serve_step(cfg), (params, cache, tok, seq - 1)


def trace_step(fn, args: Tuple[Any, ...]) -> Dict:
    """Run ``fn(*args)`` once (meta arguments) under the two counters:
    {"flops", "temp_size_in_bytes", "seconds"}."""
    t0 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    live = LiveBytes(_storages(args))
    with flops, live:
        out = fn(*args)
    # the outputs' storages are outputs, not temporaries (as in XLA's
    # memory analysis)
    outputs = {live.ids[k] for k in _storages(out) if k in live.ids}
    return {"flops": float(flops.get_total_flops()),
            "temp_size_in_bytes": live.peak(outputs),
            "seconds": time.perf_counter() - t0}


def trace_cell(cell: Cell, n_layers: Optional[int] = None) -> Dict:
    """Run the cell's step once on the meta device at its local batch
    (with the config's depth, or ``n_layers``) and count its FLOPs and the
    peak of its temporaries (:func:`trace_step`)."""
    cfg = cell.cfg
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return trace_step(*_local_args(cfg, cell.kind, cell.local_batch,
                                   cell.shape.seq_len))


def temp_is_upper_bound(cell: Cell) -> bool:
    """Whether the trace's temps overstate one device's: some mesh axis
    shards a dim other than the batch (the trace divides only the batch)."""
    return cell.mesh.size > cell.shape.global_batch // cell.local_batch
