"""Lazy backend discovery — the "wrapper library" layer.

The paper's wrapper library `dlopen`s the vendor OpenCL `.so` at runtime,
resolves symbols lazily immediately before first use, returns an error code
when called before load, and can be unloaded/reloaded.  The PyTorch analogue
is: **never touch CUDA state at import time**.  All device queries sit
behind an explicit :func:`load` / :func:`discover_backend` call guarded by
the same writer-preferred RW lock the paper uses for its load-state flag.

:func:`load` also pins float32 matrix products to full IEEE precision
(``torch.set_float32_matmul_precision("highest")``, cuDNN TF32 off): TF32
keeps about three decimal digits and would move K-Means argmins away from
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.runtime.locks import RWLock


class BackendNotLoadedError(RuntimeError):
    """Raised when a backend query is made before :func:`load`.

    Mirrors the paper: "If an OpenCL method of the wrapper library is called
    before the shared library has been loaded [...] an error is returned."
    """


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """What the loaded device reports about itself."""

    name: str
    memory_bytes: int
    multiprocessors: int


# The host, for runs that ask for the CPU (correctness runs only).
HOST_CPU = ChipSpec(name="host_cpu", memory_bytes=32 * 1024**3,
                    multiprocessors=0)


@dataclasses.dataclass
class Backend:
    """A loaded backend: the device the entry points compute on."""

    platform: str            # "cuda" | "cpu"
    device_count: int
    devices: List[torch.device]
    chip: ChipSpec

    @property
    def is_cuda(self) -> bool:
        return self.platform == "cuda"

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _cuda_chip(index: int) -> ChipSpec:
    props = torch.cuda.get_device_properties(index)
    return ChipSpec(name=props.name, memory_bytes=int(props.total_memory),
                    multiprocessors=int(props.multi_processor_count))


class _BackendRegistry:
    """Process-wide backend state behind the paper's RW lock discipline."""

    def __init__(self) -> None:
        self._lock = RWLock()
        self._backends: dict = {}
        self._load_count = 0

    def load(self, device: str = "cuda") -> Backend:
        """Discover ``device`` now (the first CUDA query happens here).

        ``device="cuda"`` raises when no GPU is present: the entry points
        run on the card unless the caller asks for the CPU.
        """
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        with self._lock.write():
            if device not in self._backends:
                torch.set_float32_matmul_precision("highest")
                torch.backends.cudnn.allow_tf32 = False
                if device == "cuda":
                    if not torch.cuda.is_available():
                        raise RuntimeError(
                            "no CUDA device is available; pass device='cpu' "
                            "to run on the host")
                    count = torch.cuda.device_count()
                    self._backends[device] = Backend(
                        platform="cuda", device_count=count,
                        devices=[torch.device("cuda", i) for i in range(count)],
                        chip=_cuda_chip(0))
                else:
                    self._backends[device] = Backend(
                        platform="cpu", device_count=1,
                        devices=[torch.device("cpu")], chip=HOST_CPU)
                self._load_count += 1
            return self._backends[device]

    def unload(self) -> None:
        """Forget the backends (paper: library can be unloaded at runtime)."""
        with self._lock.write():
            self._backends.clear()

    def get(self, device: str = "cuda") -> Backend:
        with self._lock.read():
            if device not in self._backends:
                raise BackendNotLoadedError(
                    "backend not loaded; call "
                    "repro_torch.runtime.backend.load() first")
            return self._backends[device]

    @property
    def loaded(self) -> bool:
        with self._lock.read():
            return bool(self._backends)

    @property
    def load_count(self) -> int:
        with self._lock.read():
            return self._load_count


_REGISTRY = _BackendRegistry()


def load(device: str = "cuda") -> Backend:
    return _REGISTRY.load(device)


def unload() -> None:
    _REGISTRY.unload()


def get_backend(device: str = "cuda") -> Backend:
    return _REGISTRY.get(device)


def discover_backend(device: str = "cuda") -> Backend:
    """Load-if-needed and return the backend (the common entry point)."""
    return _REGISTRY.load(device)


def is_loaded() -> bool:
    return _REGISTRY.loaded
