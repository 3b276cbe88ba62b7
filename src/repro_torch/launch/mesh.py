"""Mesh construction.

The counterpart of the reference's ``repro/launch/mesh.py``.  Functions,
not module-level constants: importing this module touches no device.

The production and test meshes are abstract
(:class:`repro_torch.parallel.sharding.AbstractMesh`: axis names and
sizes, no devices): the dry-run resolves layouts on them and runs the
steps on the meta device, as the reference compiles for 512 forced host
devices.  The mesh that runs work is :func:`make_host_mesh`, the port's
1-D :class:`repro_torch.core.distributed.Mesh` of the local devices.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.distributed import Mesh, local_mesh
from repro_torch.parallel.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: (16, 16) (data, model).  Two pods: (2, 16, 16)
    (pod, data, model) — 512 devices."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model")) -> AbstractMesh:
    """A small abstract mesh (the reference's: 8 host devices)."""
    return AbstractMesh(tuple(axes), tuple(shape))


def make_host_mesh(device: str = "cuda") -> Mesh:
    """Every local device of ``device``'s kind as a 1-D data mesh."""
    return local_mesh("data", device)
