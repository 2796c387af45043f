"""Build the port's CUDA kernels from the sources in ``tpusfm_torch/csrc``.

``compile_library`` is the build step they share with the C++ runtime of
``csrc/`` (``tpusfm_torch/native.py``, g++ into ``build/native/``). Each
``.cu`` file has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
at the repository root (listed in ``.gitignore``), then loaded with
``ctypes`` through ``load_library``. The library name carries a hash of the
sources, the flags and the compiler's identity (the first line of its
``--version``), so an edited kernel or another toolchain gets another file;
a library under the current hash that does not load (built on another
machine, or truncated) is removed and built once more before the load is
given up. What the compiler printed (``-Xptxas -v``: registers,
shared memory and spills of every kernel) is kept beside the library as
``.log``. Nothing here runs at import time: the CPU tests import every
module without a CUDA toolkit.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
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


@functools.lru_cache(maxsize=None)
def _compiler_identity(compiler: str) -> str:
    """The first line of ``<compiler> --version`` (empty if it prints none)."""
    proc = subprocess.run([compiler, "--version"], capture_output=True, text=True)
    return (proc.stdout.strip().splitlines() or [""])[0]


def library_file(compiler: str, flags: list, sources: list, out_dir: str, name: str,
                 libs: tuple = ()) -> str:
    """Where ``compile_library`` keeps the library of these sources, flags and
    compiler: ``out_dir/lib<name>_<hash>.so``."""
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join([*flags, *libs]).encode())
    digest.update(_compiler_identity(compiler).encode())
    return os.path.join(out_dir, f"lib{name}_{digest.hexdigest()[:12]}.so")


def compile_library(compiler: str, flags: list, sources: list, out_dir: str, name: str,
                    libs: tuple = ()) -> str:
    """Path of the shared library ``library_file(...)`` built from ``sources``
    by ``compiler`` with ``flags`` (and ``libs`` to link), compiling it first
    when no library for these exact sources, flags and compiler exists. The
    compiler writes to a temporary file that is renamed into place, so
    processes that build at once do not see each other's partial output;
    what it printed is kept beside the library as ``.log``."""
    out = library_file(compiler, flags, sources, out_dir, name, libs)
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


def load_library(compiler: str, flags: list, sources: list, out_dir: str, name: str,
                 libs: tuple = ()) -> ctypes.CDLL:
    """``compile_library`` and then ``ctypes.CDLL``. A library found under the
    current hash that does not load (made on a machine with other shared
    libraries, or cut short) is removed and built again, once; a second
    failure raises the loader's ``OSError``."""
    path = compile_library(compiler, flags, sources, out_dir, name, libs)
    try:
        return ctypes.CDLL(path)
    except OSError:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)
        return ctypes.CDLL(compile_library(compiler, flags, sources, out_dir, name, libs))


def _kernel_build(name: str, defines: tuple):
    """compile_library's arguments for ``csrc/<name>.cu`` with ``-D`` for each
    of ``defines``."""
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    return _nvcc(), flags, [os.path.join(CSRC, name + ".cu")], BUILD_DIR, name


def library_path(name: str, defines: tuple = ()) -> str:
    """Path of the shared library built from ``csrc/<name>.cu`` (with ``-D`` for
    each of ``defines``), compiling it first when no library for this exact
    source exists."""
    return compile_library(*_kernel_build(name, defines))


def build_log(name: str, defines: tuple = ()) -> str:
    """What nvcc and ptxas printed when ``csrc/<name>.cu`` was built."""
    with open(library_path(name, defines)[:-3] + ".log") as fh:
        return fh.read()


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _loaded.get((name, defines))
        if lib is None:
            lib = load_library(*_kernel_build(name, defines))
            _loaded[(name, defines)] = lib
        return lib
