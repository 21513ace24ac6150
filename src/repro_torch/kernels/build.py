"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, which is loaded with ``ctypes``.
Builds happen at first use, from the sources in the checkout only, into
``build/kernels/`` at the repository root.  A library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded.  ``build_all`` compiles every source at once, one
``nvcc`` process per file, all started together.

Nothing here runs when the module is imported: the CPU tests import every
module of the package on a host that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load", "nvcc_path"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("congestion", "fit")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

_C = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each library's C entry points (every pointer and the stream
# as c_void_p, so ctypes never narrows them to 32 bits)
SIGNATURES = {
    "congestion": {
        "congestion_many_launch": (_C, _C, _C, _C, _I, _I, _I, _I, _C),
    },
    "fit": {
        "fit_scores_many_launch": (_C, _C, _C, _C, _C, _C, _C, _C,
                                   _I, _I, _I, _I, _C),
        "fit_scores_launch": (_C, _C, _C, _I, _I, _C, _C, _C,
                              _I, _I, _I, _C),
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from "
        "src/repro_torch/kernels/csrc/ at first use and need the CUDA "
        "toolkit (set CUDA_HOME)")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start one nvcc for ``name``; returns (process, target, tmp) or None
    when the library is already built."""
    out = _target(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, job) -> None:
    proc, out, tmp = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all() -> dict[str, str]:
    """Compile every kernel source that is not built yet, all ``nvcc``
    processes running together.  Returns the compiler output per source
    (``-Xptxas -v``: registers, shared memory and spills per kernel);
    an already-built source maps to an empty string."""
    with _LOCK:
        jobs = {name: _start(name) for name in SOURCES}
        for name, job in jobs.items():
            if job is None:
                BUILD_LOGS.setdefault(name, "")
            else:
                _finish(name, job)
    return {name: BUILD_LOGS.get(name, "") for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` set on every entry point."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib
