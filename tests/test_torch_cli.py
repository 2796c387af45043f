"""The port's command-line path: cli.main, calibration loading, the
two-view pipeline and the prompt session, on the CPU.

``cli.main`` runs on a temporary directory of PNGs with ``--device cpu``
and a small feature budget; ``load_calibration`` is held against
``tpusfm.io.load_calibration`` on the same YAML (K and dist equal,
tolerance 0: both parse the same text into float32); the two-view
pipeline meets the bars of tests/test_pipeline_extras.py; the prompt
session repeats tests/test_ui.py's two cases.
"""
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from tests.synthetic_scene import make_scene
from tpusfm.io import load_calibration as jload_calibration
from tpusfm_torch import SfMConfig, cli, ui
from tpusfm_torch import io as tio
from tpusfm_torch.io import load_calibration, load_image, mock_calibration
from tpusfm_torch.pipeline import reconstruct_two_view
from tpusfm_torch.types import Intrinsics

torch.set_num_threads(1)
CFG = dict(max_features=1024, max_matches=512, console_debug_level=5,
           min_point_count_for_homography=60)

_YAML = """%YAML:1.0
calibration_time: "Thu 01 Jan 2015"
image_width: 320
image_height: 240
camera_matrix: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ {fx}, 0., 160., 0.,
       {fy}, 120., 0., 0., 1. ]
distortion_coefficients: !!opencv-matrix
   rows: 5
   cols: 1
   dt: d
   data: [ {k1}, 1.5e-02, 0., 0., 0. ]
"""


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_views=5, n_dots=400)


@pytest.fixture(scope="module")
def image_dir(scene, tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    for v, img in enumerate((np.clip(scene[0], 0, 1) * 255.0 + 0.5).astype(np.uint8)):
        Image.fromarray(img).save(d / f"view_{v}.png")
    calib = d / "out_camera_data.yml"
    calib.write_text(_YAML.format(fx=300.0, fy=300.0, k1=0.0))
    return d, calib


def test_cli_main_writes_every_export(image_dir, tmp_path, capsys):
    d, calib = image_dir
    prefix = str(tmp_path / "rec")
    live = str(tmp_path / "live.html")
    rc = cli.main([str(d), "--device", "cpu", "--max-features", "1024", "--max-matches", "512",
                   "--calibration", str(calib), "--console-debug", "5", "--pcd", "--html",
                   "--sor-filter", "--live-html", live, "--output-prefix", prefix])
    assert rc == 0
    said = capsys.readouterr().out
    n = int(said.split("saved ")[1].split(" points")[0])
    n_before, n_after = (int(x) for x in
                         said.split("SOR filter: ")[1].split(" points")[0].split(" -> "))
    assert n == n_after and 100 < n_after <= n_before
    assert f"element vertex {n}\n" in open(prefix + "_points.ply").read()
    assert "element vertex" in open(prefix + "_cameras.ply").read()
    assert f"POINTS {n}\n" in open(prefix + "_points.pcd").read()
    assert f"{n} points" in open(prefix + "_viewer.html").read()
    # the live viewer is a listener: the run took the host loop, frame by frame
    frames = json.load(open(tmp_path / "frames.json"))
    assert len(frames) >= 2 and len(frames[0]["cams"]) == 2
    assert len(frames[-1]["pts"]) == 6 * n_before
    assert "5 cameras" in said and "mean reprojection error" in said


def test_cli_parser_has_every_reference_option():
    from tpusfm.cli import build_parser as jbuild_parser

    ref = {a.dest: a.default for a in jbuild_parser()._actions}
    got = {a.dest: a.default for a in cli.build_parser()._actions}
    assert got.pop("device") == "cuda"
    assert got == ref


def test_load_calibration_equals_reference(tmp_path):
    path = tmp_path / "calib.yml"
    path.write_text(_YAML.format(fx=812.5, fy=807.5, k1=-0.21))
    for downscale in (1.0, 2.0):
        got = load_calibration(str(path), 320, 240, downscale, device="cpu")
        want = jload_calibration(str(path), 320, 240, downscale)
        np.testing.assert_array_equal(got.K.numpy(), np.asarray(want.K))
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
        np.testing.assert_allclose(got.Kinv.numpy(), np.asarray(want.Kinv), rtol=1e-6, atol=1e-9)
    assert float(got.K[0, 0]) == 405.0 and float(got.K[0, 2]) == 80.0   # averaged, then halved
    assert float(got.dist[0]) == np.float32(-0.21)
    # a missing or broken file falls back to the mock K
    for bad in (tmp_path / "absent.yml", tmp_path / "broken.yml"):
        if bad.name == "broken.yml":
            bad.write_text("camera_matrix: [1, 2")
        got = load_calibration(str(bad), 320, 240, device="cpu")
        assert float(got.K[0, 0]) == 320.0 and float(got.K[1, 2]) == 120.0


def test_mock_calibration():
    got = mock_calibration(640, 480, device="cpu")
    np.testing.assert_array_equal(got.K.numpy(), [[640, 0, 320], [0, 640, 240], [0, 0, 1]])
    assert float(mock_calibration(640, 480, focal=2500.0, device="cpu").K[1, 1]) == 2500.0
    np.testing.assert_allclose((got.K @ got.Kinv).numpy(), np.eye(3), atol=1e-6)


def test_load_image(image_dir, scene):
    d, _ = image_dir
    gray, rgb = load_image(str(d / "view_0.png"))
    assert gray.shape == (240, 320) and rgb.shape == (240, 320, 3) and rgb.dtype == np.uint8
    np.testing.assert_allclose(gray, scene[0][0], atol=0.5 / 255 + 1e-6)    # 8-bit quantisation
    half, _ = load_image(str(d / "view_0.png"), downscale=2.0)
    assert half.shape == (120, 160)
    np.testing.assert_array_equal(tio.load_image_directory(str(d)).gray[0], gray)


def test_two_view_pipeline(scene):
    imgs, _, K, _ = scene
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    rec = reconstruct_two_view(imgs[0], imgs[1], SfMConfig(**CFG), intr, device="cpu")
    assert int(rec.pose_valid.sum()) == 2
    assert rec.num_points > 30
    assert rec.mean_reprojection_error < 1.5
    assert rec.rgb.shape == (rec.num_points, 3)


class _FakeImages:
    def __init__(self, gray):
        self.gray = gray
        self.rgb = None
        self.num_views = gray.shape[0]


def test_interactive_session_commands(monkeypatch, tmp_path, scene):
    """The command loop mirrors DistanceUI's flow: choose directory,
    toggle a strategy checkbox, press match / recover-depth / visualize
    (legacy/DistanceUI.cpp:109-162)."""
    monkeypatch.setattr(tio, "load_image_directory",
                        lambda directory, downscale: _FakeImages(np.asarray(scene[0])))
    out = io.StringIO()
    script = io.StringIO(
        "dir /fake/path\n"
        "strategy bogus\n"
        "strategy of\n"
        "match\n"
        "strategy rich\n"
        "status\n"
        "match\n"
        "run\n"
        f"viz {tmp_path/'v.html'}\n"
        f"save {tmp_path/'rec'}\n"
        "quit\n"
    )
    sess = ui.interactive_loop(stream=script, out=out, base_config=SfMConfig(**CFG),
                               device="cpu")
    text = out.getvalue()
    assert "unknown strategy" in text
    assert "strategy = of" in text and "strategy = rich" in text
    assert text.count("match matrix built:") == 2     # by optical flow, then by descriptors
    assert "reconstructed" in text
    assert (tmp_path / "v.html").exists()
    assert (tmp_path / "rec_points.ply").exists()
    assert sess.rec is not None and sess.rec.num_points > 0


def test_interactive_requires_directory():
    out = io.StringIO()
    sess = ui.InteractiveSession(out=out, device="cpu")
    assert sess.handle("run")
    assert "no directory chosen" in out.getvalue()


def test_small_tools(image_dir, tmp_path, monkeypatch, capsys):
    """rotations self-check, and draw_keypoints' RICH and blob branches on
    one image and on a pair (it writes into the working directory)."""
    from tpusfm_torch.tools import draw_keypoints, rotations

    assert rotations.main() == 0
    assert "all rotation-algebra checks passed" in capsys.readouterr().out
    d, _ = image_dir
    monkeypatch.chdir(tmp_path)
    assert draw_keypoints.main(["--device", "cpu", str(d / "view_0.png")]) == 0
    assert (tmp_path / "view_0.png_keypoints.png").stat().st_size > 500
    n_kp = int(capsys.readouterr().out.split(" keypoints")[0])
    assert n_kp > 200
    assert draw_keypoints.main(["--device", "cpu", str(d / "view_0.png"),
                                str(d / "view_1.png")]) == 0
    said = capsys.readouterr().out
    n_match, n_inl = int(said.split(" matches")[0]), int(said.split(", ")[1].split(" ")[0])
    assert 16 <= n_inl <= n_match
    # the blob detector (the reference tool's SURF-like features), one image
    # and a pair matched by L2 distance
    assert draw_keypoints.main(["--detector", "blob", "--device", "cpu",
                                str(d / "view_0.png")]) == 0
    assert int(capsys.readouterr().out.split(" keypoints")[0]) > 200
    assert draw_keypoints.main(["--detector", "blob", "--device", "cpu", str(d / "view_0.png"),
                                str(d / "view_1.png")]) == 0
    said = capsys.readouterr().out
    n_match, n_inl = int(said.split(" matches")[0]), int(said.split(", ")[1].split(" ")[0])
    assert 16 <= n_inl <= n_match
