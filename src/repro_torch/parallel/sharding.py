"""Logical-axis sharding rules: one table drives DP/TP/EP/SP.

The counterpart of the reference's ``repro/parallel/sharding.py``.  Every
parameter and activation of the model layer is declared with *logical*
axis names ("batch", "heads", "ff", "expert", ...); this module maps them
to the axes of a mesh, so one table describes the single-pod (16, 16)
``(data, model)`` mesh, the multi-pod (2, 16, 16) ``(pod, data, model)``
mesh, a small test mesh or one device: only the rules change.

Parallelism styles expressed purely through the table:
- DP: "batch" -> ("pod", "data")
- TP: "heads"/"ff"/"vocab"/"ssm_inner" -> "model"
- EP: "expert" -> "model"
- SP: "seq_shard" -> "data" (long-context decode: KV/state sharded over seq)

Differences from the reference, by design (ROADMAP.md section 3):

- a layout is a :class:`Spec` (a tuple of ``None``, an axis name or a tuple
  of names, trailing ``None`` dropped as ``PartitionSpec`` drops them), not
  a ``jax.sharding.PartitionSpec``;
- a mesh is anything with ``axis_names`` and a ``shape`` mapping of axis to
  size, the two attributes the rules read: :class:`AbstractMesh` holds no
  device.  The dry-run (``launch/dryrun.py``) resolves layouts on abstract
  meshes and runs the steps on the meta device;
- :func:`lshard` is the identity: the port runs each step on one device
  (or a :class:`repro_torch.core.distributed.Mesh` that repeats one) and
  has no compiler to hand a constraint to.  The models do not call it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """A layout: one entry per dim (``None``, a mesh axis, or a tuple of
    mesh axes), trailing ``None`` entries dropped."""

    def __new__(cls, *entries: MeshAxes) -> "Spec":
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A named mesh shape with no devices: what layouts are resolved on."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes} "
                             f"differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axes (or None = replicated)."""

    table: Tuple[Tuple[str, MeshAxes], ...]

    def get(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for k, v in self.table:
            if k == logical:
                return v
        return None

    def override(self, **kw: MeshAxes) -> "ShardingRules":
        table = tuple((k, kw.pop(k, v)) for k, v in self.table)
        table += tuple(kw.items())
        return ShardingRules(table)


DEFAULT_RULES = ShardingRules(
    table=(
        # activations
        ("batch", ("pod", "data")),
        ("seq", None),              # sequence replicated by default
        ("seq_kv", None),           # KV-cache seq dim (SP override -> "data")
        ("seq_shard", "data"),      # SP: long-context KV/state sharding
        ("embed", None),            # residual stream replicated
        ("heads", "model"),
        ("kv_heads", "model"),
        ("head_dim", None),
        ("ff", "model"),
        ("vocab", "model"),
        ("expert", "model"),
        ("expert_capacity", None),
        ("ssm_inner", "model"),
        ("ssm_state", None),
        ("conv_kernel", None),
        ("dt_rank", None),
        ("layers", None),           # stacked layer groups
        # clustering (the paper's side of the house)
        ("points", ("pod", "data")),
        ("centroids", "model"),
        ("features", None),
    )
)


def _filter_axes(mesh, axes: MeshAxes) -> MeshAxes:
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on 1 pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh.axis_names else None
    present = tuple(a for a in axes if a in mesh.axis_names)
    return present if present else None


def logical_to_spec(rules: ShardingRules,
                    logical_axes: Tuple[Optional[str], ...],
                    mesh=None) -> Spec:
    """Map a tuple of logical axis names to a :class:`Spec`."""
    spec = []
    for ax in logical_axes:
        m = rules.get(ax)
        if mesh is not None:
            m = _filter_axes(mesh, m)
        spec.append(m)
    return Spec(*spec)


# -- in-model constraints ----------------------------------------------------

_ACTIVE_RULES: list = [DEFAULT_RULES]


@contextlib.contextmanager
def logical_axis_rules(rules: ShardingRules):
    _ACTIVE_RULES.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE_RULES.pop()


def current_rules() -> ShardingRules:
    return _ACTIVE_RULES[-1]


def _axes_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    shape: Mapping[str, int] = mesh.shape
    if isinstance(axes, str):
        return shape[axes]
    size = 1
    for a in axes:
        size *= shape[a]
    return size


def spec_for_shape(
    rules: ShardingRules,
    logical_axes: Tuple[Optional[str], ...],
    mesh,
    shape: Tuple[int, ...],
) -> Spec:
    """Shape-aware spec: drops mesh axes that do not divide the dim evenly.

    Published configs include odd sizes (36 heads, vocab 92553 pre-padding,
    kv=2), so sharding degrades per tensor instead of failing: a
    non-divisible dim is replicated (and :mod:`.resolve` may re-assign the
    freed mesh axis to a fan-in dim).
    """
    spec = []
    used: set = set()
    for ax, dim in zip(logical_axes, shape):
        m = _filter_axes(mesh, rules.get(ax))
        if isinstance(m, str):
            m = (m,)
        if m is not None:
            m = tuple(a for a in m if a not in used)
            # greedy prefix that divides the dim
            while m and dim % _axes_size(mesh, m) != 0:
                m = m[:-1]
            m = m or None
        if m is not None:
            used.update(m)
            spec.append(m if len(m) > 1 else m[0])
        else:
            spec.append(None)
    return Spec(*spec)


def lshard(x, *logical_axes: Optional[str]):
    """The identity (see the module docstring): kept so code written
    against the reference's API runs unchanged."""
    del logical_axes
    return x


def local_shape(spec: Spec, shape: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` laid out
    by ``spec`` (whose axes divide their dims, as the rules make them)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for ent, dim in zip(entries, shape):
        size = _axes_size(mesh, ent)
        if dim % size:
            raise ValueError(f"dim {dim} does not divide over {ent} ({size})")
        out.append(dim // size)
    return tuple(out)
