"""A run on the CPU at the configuration's tiny sizes (the harness's look
for a card skipped, everything else as on the card) with the timed path
broken underneath: each fault the cells can have makes ``correct`` false,
and the sound run is correct."""
import copy
import dataclasses

import pytest
import torch

from portbench import run
from portbench.run import run_cell


def _run(monkeypatch, fault, cell="crazyhorse7.fused"):
    fault(monkeypatch)
    return run_cell(cell, 2**40 + 17, 0.1, False, device="cpu", tiny=True, log=lambda m: None)


def match_altered(mp):
    """K1's answer altered where it is produced: pair 0's key indices shifted."""
    from tpusfm_torch.features import pallas_match

    plain = pallas_match.match_topk2

    def altered(d1, d2, v2):
        best, second, idx = plain(d1, d2, v2)
        idx = idx.clone()
        idx[0] = (idx[0] + 1) % d2.shape[1]
        return best, second, idx

    mp.setattr(pallas_match, "match_topk2", altered)


def keypoints_moved(mp):
    """The detector's answer altered: every sub-pixel offset off by 0.25 px."""
    from tpusfm_torch.features import detect

    plain = detect._subpixel_offsets
    mp.setattr(detect, "_subpixel_offsets", lambda *a: tuple(o + 0.25 for o in plain(*a)))


def half_the_views_left_out(mp):
    """Half of the batch left out: the detector returns no keypoints for the
    second half of the views."""
    from tpusfm_torch.pipeline import incremental

    plain = incremental.extract_features

    def half(images, **kw):
        f = plain(images, **kw)
        valid = f.valid.clone()
        valid[f.valid.shape[0] // 2:] = False
        return dataclasses.replace(f, valid=valid)

    mp.setattr(incremental, "extract_features", half)


def points_altered(mp):
    """The reconstruction's answer altered where it is produced: its points moved."""
    from tpusfm_torch.pipeline import incremental

    plain = incremental.SfMPipeline._reconstruction

    def moved(self, err):
        rec = plain(self, err)
        return dataclasses.replace(rec, xyz=rec.xyz + 0.05)

    mp.setattr(incremental.SfMPipeline, "_reconstruction", moved)


def bundle_adjustment_unchanged(mp):
    """A step that returns its state unchanged: every bundle adjustment of the
    fused engine runs no iteration."""
    from tpusfm_torch.pipeline import engine

    plain = engine.lm_solve
    mp.setattr(engine, "lm_solve", lambda prob, **kw: plain(prob, **dict(kw, max_iterations=0)))


def camera_update_zeroed(mp):
    """The cameras' state left unchanged by every bundle adjustment while the
    points still move: each LM step of ``ba/lm.py`` (the fused engine's and
    the host loop's) returns no camera or focal update."""
    from tpusfm_torch.ba import lm

    plain = lm._lm_step

    def points_only(*a, **kw):
        d_cams, d_points, d_focal, d_pp, pred = plain(*a, **kw)
        return torch.zeros_like(d_cams), d_points, torch.zeros_like(d_focal), d_pp, pred

    mp.setattr(lm, "_lm_step", points_only)


FAULTS = [match_altered, keypoints_moved, half_the_views_left_out, points_altered,
          bundle_adjustment_unchanged, camera_update_zeroed]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    res = _run(monkeypatch, fault)
    assert res["correct"] is False, res["checks"]


def test_the_sound_run_is_correct_and_measures_nothing_on_the_cpu(monkeypatch):
    res = _run(monkeypatch, lambda mp: None)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"


def test_the_camera_fault_is_caught_by_the_camera_gap(monkeypatch):
    res = _run(monkeypatch, camera_update_zeroed)
    assert res["checks"]["camera_gap"]["value"] > res["checks"]["camera_gap"]["limit"]


def test_the_host_loop_cell_rehearses(monkeypatch):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    res = _run(monkeypatch, lambda mp: None, "crazyhorse7.hostloop")
    assert res["attempted"] >= 1 and res["metrics"] == {}
    assert all(c["value"] is not None for c in res["checks"].values()), res["checks"]


# The collection job kind and the ring scene kind wait for a ring cell; here a
# tiny ring, as such a cell's files would state it, drives them end to end.
TINY_RING = {
    "name": "ring_tiny", "scene": {"kind": "ring_sector", "ring_views": 160, "views": 10,
                                   "height": 96, "width": 128, "focal": 150.0},
    "pipeline": {"max_features": 256, "max_matches": 128, "collection_window": 6,
                 "collection_wraparound": False, "collection_local_ba_cams": 8,
                 "collection_global_ba_interval": 50, "ba_incremental_iterations": 10,
                 "ba_max_iterations": 75, "ba_share_focal": False,
                 "min_point_count_for_homography": 60},
    "bars": {"min_cameras": 9, "max_reprojection_px": 1.0, "max_ate_of_spread": 0.05},
    "final_ba_huber_px": 3.0,
}


def test_the_collection_job_kind_rehearses(monkeypatch):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    cell = run.load_cell("crazyhorse7.fused", tiny=True)
    wl = dict(copy.deepcopy(cell["workload"]), job="collection", pool=1, jobs=[0],
              pipeline={})
    ring = dict(cell, name="ring_tiny", config=TINY_RING, workload=wl,
                pipeline=dict(TINY_RING["pipeline"]))
    monkeypatch.setattr(run, "load_cell", lambda name, tiny=False: ring)
    res = run_cell("ring_tiny", 2**40 + 17, 0.1, False, device="cpu", tiny=True,
                   log=lambda m: None)
    assert res["attempted"] >= 1 and res["metrics"] == {}
    assert all(c["value"] is not None for c in res["checks"].values()), res["checks"]
