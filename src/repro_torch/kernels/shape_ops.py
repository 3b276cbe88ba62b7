"""Shape-only ops: what a kernel wrapper runs on the meta device.

The dry-run (``launch/dryrun.py``) runs the steps on meta tensors, which
hold a shape and no data.  A wrapper given one calls its kernel's shape
op, ``torch.ops.repro_torch.<name>``: empty outputs of the kernel's shapes
and dtypes, no launch counted, and the kernel's operations registered as
the op's FLOPs with ``torch.utils.flop_counter``, so a
``FlopCounterMode`` over the step counts them.  It is shape inference,
not the plain version.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def define(name: str, schema: str, meta: Callable, flops: Callable):
    """Register ``repro_torch::<name>(<schema>)`` with ``meta`` as its
    Meta kernel and ``flops(*args)`` (tensors passed as their shapes) as
    its FLOP count; returns the op.  Registering a name twice keeps the
    first."""
    if not hasattr(torch.ops.repro_torch, name):
        _LIB.define(f"{name}{schema}")
        _LIB.impl(name, meta, "Meta")
        register_flop_formula(getattr(torch.ops.repro_torch, name))(
            lambda *args, out_shape=None, **kwargs: flops(*args))
    return getattr(torch.ops.repro_torch, name)
