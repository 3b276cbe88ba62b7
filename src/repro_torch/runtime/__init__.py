"""Runtime substrate: the CUDA-side analogue of the paper's OpenCL wrapper library.

- :mod:`repro_torch.runtime.backend`    -- lazy CUDA discovery
- :mod:`repro_torch.runtime.locks`      -- the RW lock (direct port)
- :mod:`repro_torch.runtime.preemption` -- SIGTERM -> suspend, hold-alive
"""

from repro_torch.runtime.locks import RWLock
from repro_torch.runtime.backend import Backend, discover_backend

__all__ = ["RWLock", "Backend", "discover_backend"]
