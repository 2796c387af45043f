"""ctypes bindings to the native C++ runtime of ``csrc/``.

Counterpart of ``tpusfm/native.py``, with the same functions, argument
conversions and return values: threaded image decode (``csrc/imageio.cc``)
and the track-graph bookkeeping of the host loop (``csrc/trackgraph.cc``:
the point merge and the 2D-3D scan). The port builds its own libraries from
those unchanged sources with ``g++ -O3 -fPIC -shared -std=c++17`` on first
use, into ``build/native/`` at the repository root, each named by a hash of
its sources, flags and compiler (``_build.load_library``, which builds once
more a library under that name that does not load). There are two: the
track graph alone, and the image decoder linked with ``-ljpeg -lpng
-lpthread``, so a machine without the JPEG or PNG headers still gets the
track graph. Every caller has a numpy or PIL fallback for a library that
does not build; ``build_report()`` says what was built and, for a library
that was not, the compiler's reason.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from tpusfm_torch._build import load_library

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_ROOT, "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
# library -> (sources in csrc/, libraries to link)
_LIBS = {"trackgraph": (("trackgraph.cc",), ()),
         "imageio": (("imageio.cc",), ("-ljpeg", "-lpng", "-lpthread"))}

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_SIGNATURES = {
    "trackgraph": {
        "tpusfm_insert_points": [_p, _p, _p, _i, _i, _i, _i, _i, _i, _p, _p, _p, _i, _p],
        "tpusfm_insert_points_v2": [_p, _p, _p, _i, _i, _i, _i, _i, _i, _p, _p, _p, _i,
                                    _p, _p, _p, _p, _f, _f, _f, _i, _p, _p, _f, _f, _f, _f, _p],
        "tpusfm_find_2d3d": [_p, _i, _i, _i, _p, _i, _p, _p, _p, _i, _p, _p, _p],
    },
    "imageio": {
        "tpusfm_load_images": [ctypes.POINTER(ctypes.c_char_p), _i, _i, _i, _p, _p, _i],
        "tpusfm_image_size": [ctypes.c_char_p, ctypes.POINTER(_i), ctypes.POINTER(_i)],
    },
}

_lock = threading.Lock()
_loaded: dict = {}      # name -> CDLL, or the reason it is unavailable (str)


def _lib(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` (built on first use), or None."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = _build_and_load(name)
        lib = _loaded[name]
    return None if isinstance(lib, str) else lib


def _build_and_load(name: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return "no C++ compiler (g++ or c++) on the PATH"
    sources, libs = _LIBS[name]
    try:
        lib = load_library(cxx, CXX_FLAGS, [os.path.join(_CSRC, s) for s in sources],
                           BUILD_DIR, f"tpusfm_{name}", libs)
    except (RuntimeError, OSError) as e:
        return str(e)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    return lib


def available() -> bool:
    """Whether the track-graph runtime (merge and 2D-3D scan) is loaded."""
    return _lib("trackgraph") is not None


def build_report() -> dict:
    """{library: "built" or the reason it is unavailable}, building each."""
    for name in _LIBS:
        _lib(name)
    return {name: "built" if not isinstance(v, str) else v for name, v in _loaded.items()}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _inplace(a: np.ndarray, dtype) -> np.ndarray:
    """An array the native code writes into: it must already be C-contiguous
    with this dtype, or the writes would not reach it."""
    if a.dtype != dtype or not a.flags.c_contiguous or not a.flags.writeable:
        raise ValueError(f"native runtime needs a writeable C-contiguous {np.dtype(dtype)} "
                         f"array, got {a.dtype} {a.shape}")
    return a


def load_images(paths, target_h: int, target_w: int, n_threads: int = 0):
    """Threaded native decode -> (rgb (N,H,W,3) u8, gray (N,H,W) f32).

    Returns None if the decoder is unavailable or any decode fails."""
    lib = _lib("imageio")
    if lib is None:
        return None
    n = len(paths)
    rgb = np.zeros((n, target_h, target_w, 3), np.uint8)
    gray = np.zeros((n, target_h, target_w), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ok = lib.tpusfm_load_images(arr, n, target_h, target_w, _ptr(rgb), _ptr(gray), n_threads)
    if ok != n:
        return None
    return rgb, gray


def image_size(path: str):
    """(h, w) of an image file, or None."""
    lib = _lib("imageio")
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if not lib.tpusfm_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        return None
    return h.value, w.value


def insert_points(xyz: np.ndarray, obs: np.ndarray, feat2point: np.ndarray,
                  n_points: int, vi: int, vj: int, new_xyz: np.ndarray,
                  fi: np.ndarray, fj: np.ndarray):
    """Native mergeNewPointCloud without the 3D-distance merge. Mutates
    xyz/obs/feat2point in place.

    Returns (new_n_points, appended, merged) or None when unavailable."""
    lib = _lib("trackgraph")
    if lib is None:
        return None
    cap, V = obs.shape
    F = feat2point.shape[1]
    stats = np.zeros(2, np.int32)
    nxyz = np.ascontiguousarray(new_xyz, np.float32)
    fi = np.ascontiguousarray(fi, np.int32)
    fj = np.ascontiguousarray(fj, np.int32)
    n2 = lib.tpusfm_insert_points(
        _ptr(_inplace(xyz, np.float32)), _ptr(_inplace(obs, np.int32)),
        _ptr(_inplace(feat2point, np.int32)), cap, V, F, n_points,
        vi, vj, _ptr(nxyz), _ptr(fi), _ptr(fj), len(fi), _ptr(stats))
    return n2, int(stats[0]), int(stats[1])


def insert_points_v2(xyz: np.ndarray, obs: np.ndarray, feat2point: np.ndarray,
                     n_points: int, vi: int, vj: int, new_xyz: np.ndarray,
                     fi: np.ndarray, fj: np.ndarray, pair_row: np.ndarray,
                     right_of: np.ndarray, rdist: np.ndarray,
                     left_of: np.ndarray, merge_dist: float, feat_dist: float,
                     strengthen_dist: float, strengthen: bool,
                     poses: np.ndarray | None = None,
                     feat_xy: np.ndarray | None = None,
                     focal: float = 0.0, cx: float = 0.0, cy: float = 0.0,
                     reproj_gate: float = 0.0):
    """Native full mergeNewPointCloud (SfM.cpp:530-629): exact and
    transitive feature claims, 3D-distance merge with feature confirmation,
    sequential like the reference. Mutates xyz/obs/feat2point in place.

    A transitive (strengthening) claim is also confirmed by reprojecting the
    claimed map point into both originating views within reproj_gate pixels
    when poses and feat_xy are given.

    Returns (new_n_points, appended, merged, dropped) or None."""
    lib = _lib("trackgraph")
    if lib is None:
        return None
    cap, V = obs.shape
    F = feat2point.shape[1]
    stats = np.zeros(3, np.int32)
    nxyz = np.ascontiguousarray(new_xyz, np.float32)
    fi = np.ascontiguousarray(fi, np.int32)
    fj = np.ascontiguousarray(fj, np.int32)
    pr = np.ascontiguousarray(pair_row, np.int32)
    ro = np.ascontiguousarray(right_of, np.int32)
    rd = np.ascontiguousarray(rdist, np.float32)
    lo = np.ascontiguousarray(left_of, np.int32)
    if poses is not None and feat_xy is not None:
        ps = np.ascontiguousarray(poses, np.float32)
        fx = np.ascontiguousarray(feat_xy, np.float32)
        ps_p, fx_p = _ptr(ps), _ptr(fx)
    else:
        ps_p = fx_p = None
        reproj_gate = 0.0
    n2 = lib.tpusfm_insert_points_v2(
        _ptr(_inplace(xyz, np.float32)), _ptr(_inplace(obs, np.int32)),
        _ptr(_inplace(feat2point, np.int32)), cap, V, F, n_points,
        vi, vj, _ptr(nxyz), _ptr(fi), _ptr(fj), len(fi),
        _ptr(pr), _ptr(ro), _ptr(rd), _ptr(lo),
        merge_dist, feat_dist, strengthen_dist, int(strengthen),
        ps_p, fx_p, focal, cx, cy, reproj_gate, _ptr(stats))
    return n2, int(stats[0]), int(stats[1]), int(stats[2])


def find_2d3d(feat2point: np.ndarray, view: int, good_views, pair_row: np.ndarray,
              match_idx: np.ndarray, match_valid: np.ndarray):
    """Native find2D3DMatches. Returns (feats, points) int32 arrays or None."""
    lib = _lib("trackgraph")
    if lib is None:
        return None
    V, F = feat2point.shape
    M = match_idx.shape[1]
    f2p = np.ascontiguousarray(feat2point, np.int32)
    gv = np.ascontiguousarray(sorted(good_views), np.int32)
    pr = np.ascontiguousarray(pair_row, np.int32)
    pof = np.full(F, -1, np.int32)
    out_f = np.zeros(F, np.int32)
    out_p = np.zeros(F, np.int32)
    mi = np.ascontiguousarray(match_idx, np.int32)
    mv = np.ascontiguousarray(match_valid, np.uint8)
    cnt = lib.tpusfm_find_2d3d(
        _ptr(f2p), V, F, view, _ptr(gv), len(gv), _ptr(pr),
        _ptr(mi), _ptr(mv), M, _ptr(pof), _ptr(out_f), _ptr(out_p))
    return out_f[:cnt].copy(), out_p[:cnt].copy()
