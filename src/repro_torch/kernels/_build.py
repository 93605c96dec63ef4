"""Build and load the CUDA sources under ``repro_torch/csrc/``.

Each ``<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. Builds happen at first use, into
``build/repro_torch_kernels/<hash>/`` at the root of the checkout (or
``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of the source, the shared
``*.cuh`` headers and the flags, so an edited source is rebuilt and an
unchanged one is not.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ENV = "REPRO_TORCH_BUILD_DIR"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> CUDA source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else from ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch_kernels`` at
    the root of the checkout (``src/repro_torch/kernels`` -> three up)."""
    env = os.environ.get(BUILD_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def headers() -> Dict[str, Path]:
    """Header name -> source: the ``*.cuh`` files the sources include."""
    return {p.name: p for p in sorted(CSRC.glob("*.cuh"))}


def _key(names: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs = sources()
    for name in sorted(names):
        h.update(name.encode())
        h.update(srcs[name].read_bytes())
    for name, path in headers().items():  # an edited header rebuilds every source
        h.update(name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / _key([name]) / f"lib{name}.so"


class _Job:
    """One running ``nvcc``: compiles to a temporary file, renamed into
    place only on success (a concurrent loader sees all or nothing)."""

    def __init__(self, name: str):
        self.name = name
        self.out = _lib_path(name)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.parent / f"lib{name}.{os.getpid()}.tmp.so"
        self.cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(self.tmp),
                    str(sources()[name])]
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> str:
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.name} (exit "
                               f"{self.proc.returncode}):\n{' '.join(self.cmd)}\n{log}")
        os.replace(self.tmp, self.out)
        self.out.with_suffix(".log").write_text(log)
        return log


def build_all(names: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every source (or ``names``) not yet built, one ``nvcc`` per
    source, all started together. Returns name -> compiler log (the
    ``ptxas -v`` register and shared-memory report)."""
    names = list(names) or list(sources())
    jobs = [_Job(n) for n in names if not _lib_path(n).exists()]
    logs = {}
    errors = []
    for job in jobs:  # wait for every job, even after one failed
        try:
            logs[job.name] = job.finish()
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for n in names:
        if n not in logs:
            log = _lib_path(n).with_suffix(".log")
            logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def entry_point(name: str, symbol: str, argtypes):
    """``(fn, error_string)``: C function ``symbol`` of kernel ``name``'s
    library with its signature declared (it returns a ``cudaError_t`` as an
    int), and the library's ``<name>_error_string``."""
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err
