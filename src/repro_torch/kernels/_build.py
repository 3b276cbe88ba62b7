"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds, not minutes.

- Libraries land in ``build/repro_torch/`` at the repository root (listed in
  ``.gitignore``), named ``<name>-<hash>.so`` where the hash covers the
  sources and the flags: an edited ``.cu`` builds anew, an unchanged one is
  loaded from disk.
- :func:`build_all` starts one ``nvcc`` per source, all at once, and waits;
  :func:`library` builds one on first use.  A failed build raises.
- Nothing here runs at import: the CPU tests import every module, and this
  machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which(name), os.path.join(cuda_home, "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(f"{name} not found (set CUDA_HOME or put it on "
                           f"PATH)")


def _target(name: str) -> Tuple[Path, Path]:
    """(source, library path keyed by a hash of the sources and flags)."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns the
    process (or None) and the paths."""
    src, lib = _target(name)
    if lib.exists():
        return None, src, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, src, lib


def _finish(name: str, proc, lib: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{out}")
    lib.with_suffix(".log").write_text(out)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing


def build_all() -> List[Path]:
    """Build every kernel in parallel; returns the library paths."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = [(n, *_start(n)) for n in names]
        errors = []
        for name, proc, _src, lib in started:
            try:
                _finish(name, proc, lib)
            except KernelBuildError as exc:
                errors.append(str(exc))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return [lib for _n, _p, _s, lib in started]


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built."""
    return _target(name)[1]


def build_log(name: str) -> str:
    """What ``nvcc``/``ptxas`` printed for ``name`` (registers, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str, signatures: Dict[str, Tuple[list, object]]
            ) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.

    ``signatures`` maps each C entry to its ``(argtypes, restype)``; they
    are set once, when the library is loaded.  Pointers and the stream must
    be ``c_void_p``, or ctypes passes them as 32-bit ints and cuts them.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        proc, _src, path = _start(name)
        _finish(name, proc, path)
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
