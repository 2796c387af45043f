"""Build the port's CUDA kernels from the sources in ``tpusfm_torch/csrc``.

``compile_library`` is the build step they share with the C++ runtime of
``csrc/`` (``tpusfm_torch/native.py``, g++ into ``build/native/``). Each
``.cu`` file has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
at the repository root (listed in ``.gitignore``), then loaded with
``ctypes``. The library name carries a hash of the source and of the flags,
so an edited kernel is rebuilt and a stale one is never loaded. What the compiler printed (``-Xptxas -v``: registers,
shared memory and spills of every kernel) is kept beside the library as
``.log``. Nothing here runs at import time: the CPU tests import every
module without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpusfm_torch are built "
                       "from source on the machine with the GPU")


def compile_library(compiler: str, flags: list, sources: list, out_dir: str, name: str,
                    libs: tuple = ()) -> str:
    """Path of the shared library ``out_dir/lib<name>_<hash>.so`` built from
    ``sources`` by ``compiler`` with ``flags`` (and ``libs`` to link), compiling
    it first when no library for these exact sources and flags exists. The
    compiler writes to a temporary file that is renamed into place, so
    processes that build at once do not see each other's partial output;
    what it printed is kept beside the library as ``.log``."""
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join([*flags, *libs]).encode())
    out = os.path.join(out_dir, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, *sources, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                               f"{' '.join(sources)}:\n{proc.stdout}\n{proc.stderr}")
        with open(out[:-3] + ".log", "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library_path(name: str, defines: tuple = ()) -> str:
    """Path of the shared library built from ``csrc/<name>.cu`` (with ``-D`` for
    each of ``defines``), compiling it first when no library for this exact
    source exists."""
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    return compile_library(_nvcc(), flags, [os.path.join(CSRC, name + ".cu")], BUILD_DIR, name)


def build_log(name: str, defines: tuple = ()) -> str:
    """What nvcc and ptxas printed when ``csrc/<name>.cu`` was built."""
    with open(library_path(name, defines)[:-3] + ".log") as fh:
        return fh.read()


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _loaded.get((name, defines))
        if lib is None:
            lib = ctypes.CDLL(library_path(name, defines))
            _loaded[(name, defines)] = lib
        return lib
