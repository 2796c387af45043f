"""The port's bindings to the native C++ runtime against tpusfm's.

Mirrors tests/test_native.py and the ``use_native`` cases of
tests/test_merge.py. ``tpusfm_torch.native`` builds its own libraries from
the unchanged ``csrc/*.cc`` into ``build/native/``; here they must:

  * decode images byte for byte as ``tpusfm.native.load_images`` does
    (PNG and JPEG, with and without a resize), and report the same sizes;
  * merge points exactly as tpusfm's native merge does (xyz, obs,
    feat2point and the counts equal after every call, tolerance 0), through
    the port's ``SfMPipeline._merge_points``;
  * find the same 2D-3D correspondences as the port's numpy path.

The native and the numpy merge are not the same function, in either
package: the native merge takes a call's points in order (a point sees the
points appended before it in the same call) and attaches to the first
confirmed point within the merge distance, where the numpy merge holds
every point of a call against the map as it was and confirms only the
nearest point. ``test_native_and_numpy_merges_differ`` pins that
divergence in both packages; the host loop takes the native path when it
is built, as tpusfm's does.
"""
import dataclasses
import os
import shutil
import types

import numpy as np
import pytest
import torch
from PIL import Image

import tpusfm.native as jnative
from tests.synthetic_scene import make_scene
from tests.test_torch_host_loop import CFG, _meets_bars
from tests.test_torch_merge import _pair, _same_graph, _set_matches
from tpusfm import SfMConfig as JConfig
from tpusfm.pipeline import SfMPipeline as JPipeline
from tpusfm_torch import SfMConfig, _build, convert, native
from tpusfm_torch.io import load_image_directory
from tpusfm_torch.pipeline import SfMPipeline
from tpusfm_torch.types import Intrinsics

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    """The port's runtime, built (both libraries must build here)."""
    report = native.build_report()
    assert report == {"trackgraph": "built", "imageio": "built"}, report
    assert jnative.available(), "tpusfm's own native runtime did not build"
    return report


def test_libraries_are_built_into_build_native(built):
    names = sorted(f for f in os.listdir(native.BUILD_DIR) if f.endswith(".so"))
    kinds = {n.rsplit("_", 1)[0] for n in names}
    assert {"libtpusfm_trackgraph", "libtpusfm_imageio"} <= kinds
    # the file name carries a hash of the sources and flags
    assert all(len(n.rsplit("_", 1)[1]) == len("0123456789ab.so") for n in names)
    assert native.available()


def _foreign_trackgraph(build_dir) -> str:
    """Write a file that is not a library where the loader looks for the
    track graph's build in ``build_dir``, as a build copied from another
    machine would lie there; return its path."""
    sources, libs = native._LIBS["trackgraph"]
    path = _build.library_file(shutil.which("g++") or shutil.which("c++"), native.CXX_FLAGS,
                               [os.path.join(native._CSRC, f) for f in sources], str(build_dir),
                               "tpusfm_trackgraph", libs)
    os.makedirs(build_dir, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"not a shared library")
    return path


def test_foreign_library_is_rebuilt(tmp_path, monkeypatch):
    """A library under the current hash that does not load is removed, built
    again and loaded: the track graph stays available."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_loaded", {})
    path = _foreign_trackgraph(tmp_path)
    assert native.available()
    with open(path, "rb") as fh:
        assert fh.read(4) == b"\x7fELF"


def test_second_load_failure_is_reported(tmp_path, monkeypatch):
    """When the rebuilt library fails to load too, the runtime reports the
    loader's reason and the callers take their fallback."""
    calls = []

    def refuse(path):
        calls.append(path)
        raise OSError(f"{path}: cannot load (forced)")

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(CDLL=refuse))
    path = _foreign_trackgraph(tmp_path)
    assert not native.available()
    assert calls == [path, path]
    report = native.build_report()
    assert "cannot load (forced)" in report["trackgraph"], report
    assert native.insert_points(np.zeros((4, 3), np.float32), np.full((4, 2), -1, np.int32),
                                np.full((2, 8), -1, np.int32), 0, 0, 1,
                                np.zeros((1, 3), np.float32), np.zeros(1, np.int32),
                                np.zeros(1, np.int32)) is None


@pytest.mark.parametrize("ext,size", [(".png", (60, 80)), (".png", (30, 40)),
                                      (".jpg", (64, 64)), (".jpg", (32, 48))])
def test_load_images_equals_reference(built, tmp_path, ext, size):
    rng = np.random.default_rng(len(ext) + size[0])
    paths = []
    for k in range(3):
        img = rng.uniform(0, 255, (60, 80, 3)).astype(np.uint8)
        if ext == ".jpg":
            img = np.tile(np.linspace(0, 255, 64, dtype=np.uint8)[None, :, None], (64, 1, 3))
        paths.append(str(tmp_path / f"im{k}{ext}"))
        Image.fromarray(img).save(paths[-1], **({"quality": 95} if ext == ".jpg" else {}))
    got = native.load_images(paths, *size)
    want = jnative.load_images(paths, *size)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert native.image_size(paths[0]) == jnative.image_size(paths[0])
    assert native.image_size(str(tmp_path / "missing.png")) is None


def test_load_image_directory_native_and_pil(built, tmp_path, monkeypatch):
    """The directory loader takes the native decoder; on PNGs it gives the
    PIL path's bytes and the same gray."""
    rng = np.random.default_rng(0)
    for k in range(3):
        Image.fromarray(rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)).save(
            tmp_path / f"v{k}.png")
    fast = load_image_directory(str(tmp_path))
    monkeypatch.setattr(native, "load_images", lambda *a, **k: None)
    slow = load_image_directory(str(tmp_path))
    assert fast.paths == slow.paths
    np.testing.assert_array_equal(fast.rgb, slow.rgb)
    np.testing.assert_array_equal(fast.gray, slow.gray)


def test_insert_points_v1_equals_reference(built):
    cap, V, F = 64, 3, 32
    states = []
    for mod in (native, jnative):
        xyz = np.zeros((cap, 3), np.float32)
        obs = np.full((cap, V), -1, np.int32)
        f2p = np.full((V, F), -1, np.int32)
        out = [mod.insert_points(xyz, obs, f2p, 0, 0, 1, np.arange(12, dtype=np.float32)
                                 .reshape(4, 3), np.array([1, 2, 3, 4]), np.array([5, 6, 7, 8]))]
        out.append(mod.insert_points(xyz, obs, f2p, out[0][0], 0, 2, np.ones((2, 3), np.float32),
                                     np.array([1, 9]), np.array([10, 11])))
        states.append((out, xyz, obs, f2p))
    assert states[0][0] == states[1][0] == [(4, 4, 0), (5, 1, 1)]
    for a, b in zip(states[0][1:], states[1][1:]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.insert_points(np.zeros((cap, 3)), obs, f2p, 0, 0, 1, np.zeros((1, 3)),
                             np.array([1]), np.array([2]))


@pytest.mark.parametrize("strengthen,with_xy", [(True, True), (True, False), (False, True)])
def test_merge_equals_reference_native(built, strengthen, with_xy):
    """The random workload of tests/test_torch_merge.py, on both packages'
    native merges."""
    jp, tp, rng = _pair(cross_view_strengthen=strengthen)
    if not with_xy:
        jp.feat_xy = tp.feat_xy = None
    offered = 0
    for _ in range(14):
        k = int(rng.integers(3, 20))
        i, j = (int(v) for v in sorted(rng.choice(jp.V, 2, replace=False)))
        p = jp.pair_of[(i, j)]
        fi = np.where(rng.uniform(0, 1, k) < 0.7, jp.match_idx[p, rng.integers(0, 24, k), 0],
                      rng.integers(0, 64, k)).clip(0).astype(np.int32)
        fj = np.where(rng.uniform(0, 1, k) < 0.7, jp.match_idx[p, rng.integers(0, 24, k), 1],
                      rng.integers(0, 64, k)).clip(0).astype(np.int32)
        xyz = (rng.uniform(-1, 1, (k, 3)) + np.array([0, 0, 6])).astype(np.float32)
        if jp.n_points:
            near = rng.integers(0, jp.n_points, k)
            close = rng.uniform(0, 1, k) < 0.5
            xyz[close] = jp.xyz[near[close]] + np.float32(1e-3)
        jp._insert_points(xyz.copy(), i, fi.copy(), j, fj.copy())       # native when built
        tp._merge_points(xyz.copy(), i, fi.copy(), j, fj.copy())
        _same_graph(jp, tp)
        offered += k
    assert tp._timings["native"] is True
    assert jp.n_points > 16 and jp.n_points < offered


def test_native_and_numpy_merges_differ(built, monkeypatch):
    """One call offering two new points 0.002 apart: the native merge
    appends the first and drops the second (close to it, no 2D match
    confirms them); the numpy merge holds both against the empty map and
    appends both. tpusfm's two paths differ the same way."""
    def run(pipe, merge):
        idx = np.full((3, 4, 2), -1, np.int32)
        _set_matches(pipe, idx, np.zeros((3, 4), bool), np.full((3, 4), 1e9, np.float32))
        merge(np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.002]], np.float32),
              0, np.array([2, 3]), 1, np.array([4, 5]))
        return pipe.n_points, pipe.obs[: pipe.n_points].tolist()

    jcfg = JConfig(max_features=32, max_matches=4, console_debug_level=5)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    imgs = np.zeros((3, 32, 32), np.float32)
    tn = SfMPipeline(imgs, cfg, device="cpu")
    on_native = run(tn, tn._merge_points)
    jn = JPipeline(imgs, jcfg)
    assert run(jn, jn._insert_points) == on_native                    # tpusfm, native
    tp = SfMPipeline(imgs, cfg, device="cpu")
    on_numpy = run(tp, tp._insert_points)
    monkeypatch.setattr(jnative, "available", lambda: False)
    jp = JPipeline(imgs, jcfg)
    assert run(jp, jp._insert_points) == on_numpy                     # tpusfm, numpy
    assert on_native[0] == 1 and on_numpy[0] == 2


def test_find_2d3d_native_equals_numpy(built, monkeypatch):
    _, tp, rng = _pair(seed=5)
    tp.feat2point = np.where(rng.uniform(0, 1, tp.feat2point.shape) < 0.5,
                             rng.integers(0, 40, tp.feat2point.shape), -1).astype(np.int32)
    tp.good_views = {0, 2}
    fast = [tp.find_2d3d_matches(v) for v in (1, 3)]
    monkeypatch.setattr(native, "available", lambda: False)
    slow = [tp.find_2d3d_matches(v) for v in (1, 3)]
    for (ff, fp), (sf, sp) in zip(fast, slow):
        assert ff.dtype == np.int32
        np.testing.assert_array_equal(ff, sf)
        np.testing.assert_array_equal(fp, sp)
    assert sum(len(f) for f, _ in fast) > 5


def test_host_loop_native_and_numpy(built, monkeypatch):
    """The host loop on the 5-view dot scene at seed 1, once on each merge:
    the stats name the path, and both runs meet the reference's bars."""
    imgs, gt, K, _ = make_scene(n_views=5, n_dots=400)
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    cfg = SfMConfig(**CFG, fused=False)
    fast = SfMPipeline(imgs, cfg, intrinsics=intr, seed=1, device="cpu").run()
    monkeypatch.setattr(native, "available", lambda: False)
    slow = SfMPipeline(imgs, cfg, intrinsics=intr, seed=1, device="cpu").run()
    assert fast.stats["native"] is True and slow.stats["native"] is False
    for rec in (fast, slow):
        _meets_bars(gt, rec.poses, rec.pose_valid, rec.mean_reprojection_error)
