"""The collection cell ``ring500.sector``: its rehearsal on the CPU at the
configuration's tiny sizes (a 10-view sector of a 160-view ring at the cell's
own 256x192), a fault in the COO bundle adjuster that the comparison must
catch, the comparison's control, the Huber scale the reference judges the
final solve at, and the five readers of the collection's timings and spans
on recorded events."""
import json
import os

import pytest
import torch

from portbench import run
from portbench.run import HERE, load_module, run_cell
from portbench.tests.test_portbench_spans import KINDS, _job

CELL = "ring500.sector"
SEED = 2**40 + 17


def _rehearse(**kw):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    return run_cell(CELL, SEED, 0.1, False, device="cpu", tiny=True, log=lambda m: None, **kw)


def _within(res):
    return {k: c for k, c in res["checks"].items()
            if c["value"] is not None and c["value"] <= c["limit"]}


def test_the_ring_cell_rehearses_within_its_limits():
    res = _rehearse()
    assert res["correct"] is True and res["attempted"] >= 1, res["checks"]
    assert set(_within(res)) == set(res["checks"]), res["checks"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"


def sparse_camera_update_zeroed(mp):
    """The cameras' state left unchanged by every COO bundle adjustment while
    the points still move: each LM step of ``ba/sparse.py`` (the local and the
    global solves of the collection) returns no camera or focal update."""
    from tpusfm_torch.ba import sparse

    plain = sparse._lm_step_sparse

    def points_only(*a, **kw):
        d_c, d_p, d_f, pred = plain(*a, **kw)
        return torch.zeros_like(d_c), d_p, torch.zeros_like(d_f), pred

    mp.setattr(sparse, "_lm_step_sparse", points_only)


def test_the_sparse_camera_fault_is_caught_by_the_camera_gap(monkeypatch):
    sparse_camera_update_zeroed(monkeypatch)
    res = _rehearse()
    assert res["correct"] is False
    assert res["checks"]["camera_gap"]["value"] > res["checks"]["camera_gap"]["limit"]


def test_the_control_is_not_correct():
    res = _rehearse(control=True)
    assert res["correct"] is False, res["checks"]
    assert not set(_within(res)) & {"kp_miss", "desc_miss", "point_gap", "camera_gap"}


def _conf():
    with open(os.path.join(HERE, "configs", "ring500.json")) as fh:
        return json.load(fh)


def test_the_reference_judges_at_the_final_solves_huber_scale(monkeypatch):
    """``final_ba_huber_px`` is the scale ``CollectionPipeline._final_ba``
    hands the COO solver, so the reference's gaps measure the loss it solved."""
    import numpy as np

    from tpusfm_torch import SfMConfig
    from tpusfm_torch.pipeline import collection

    huber = _conf()["final_ba_huber_px"]
    assert huber == SfMConfig().collection_huber_px > 0.0
    seen = {}
    monkeypatch.setattr(collection, "adjust_bundle_sparse",
                        lambda *a, **kw: seen.update(kw))
    cell = run.load_cell(CELL, tiny=True)
    pipe = collection.CollectionPipeline(np.zeros((2, 8, 8), np.float32),
                                         load_module("jobs", "collection").make_config(cell),
                                         device="cpu")
    pipe._final_ba()
    assert seen["huber_delta"] == huber


def test_a_tiny_ring_jobs_gaps_at_that_scale_lie_under_their_limits():
    from portbench import check

    torch.set_num_threads(min(torch.get_num_threads(), 4))
    cell = run.load_cell(CELL, tiny=True)
    conf, wl = cell["config"], cell["workload"]
    k = wl["jobs"][0]
    scene = load_module("scenes", "ring_sector").make(conf["scene"], wl["scene_seed"],
                                                      k % wl["pool"], wl["pool"], "cpu")
    job = load_module("jobs", "collection")
    out = job.run(scene, job.make_config(cell), run._seed(wl["scene_seed"], 4, k), "cpu",
                  keep=False)
    jd = check.judge_reconstruction(out, scene, conf["bars"], conf["final_ba_huber_px"], "cpu")
    assert jd["in_bars"], jd
    assert jd["point_gap"] < wl["limits"]["point_gap"]
    assert jd["camera_gap"] < wl["limits"]["camera_gap"]
    # the stats the readers and the spans' counts rest on
    st = out["stats"]
    assert st["views_tried"] >= st["views_registered"] == jd["cameras"] - 2
    assert st["ba_iters"] == st["ba_iters_local"] + st["ba_iters_global"] > 0


# --- the readers, on a recorded job: ``_job``'s add-view steps renamed as the
# collection's registration passes (5 launches, 1 sync each) and its LM
# iterations as the COO solver's (2 launches each) ---
RENAME = {"sfm.engine.step": "sfm.collection.view", "sfm.ba.lm_iter": "sfm.sparse.lm_iter"}


def _ring_job(kind="annotation", **kw):
    ctx = _job(kind=kind, **kw)
    ctx["events"] = [(RENAME.get(n, n), *rest) for n, *rest in ctx["events"]]
    ctx["calls"] = {"match_top2": [(256, 1024, 1024), (59, 1024, 1024)]}   # windowed: no V
    return ctx


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


@KINDS
def test_the_span_readers_read_the_collection(kind):
    ctx = _ring_job(kind)
    assert _read("collection.view_launches", ctx) == 5.0
    assert _read("collection.view_syncs", ctx) == 1.0
    assert _read("sparse.launches_per_iter", ctx) == 2.0
    # the dense LM's reader and the fused step's read nothing there
    assert _read("ba.launches_per_iter", ctx) is None
    assert _read("engine.step_launches", ctx) is None


@pytest.mark.parametrize("case", ["no_run", "two_runs", "overlap", "no_events"])
def test_the_span_readers_read_nothing_from_unsound_spans(case):
    ctx = _ring_job()
    ev = ctx["events"]
    if case == "no_run":          # the parent's collection opens no sfm.run
        ctx["events"] = [e for e in ev if e[0] != "sfm.run"]
    elif case == "two_runs":
        ctx["events"] = ev + [("sfm.run", "annotation", 10, 20)]
    elif case == "overlap":
        ctx["events"] = ev + [("sfm.collection.view", "annotation", 1_005, 1_500),
                              ("sfm.sparse.lm_iter", "annotation", 1_005, 1_500)]
    else:
        ctx["events"] = None
    for name in ("collection.view_launches", "collection.view_syncs",
                 "sparse.launches_per_iter"):
        assert _read(name, ctx) is None, name


def test_the_timing_readers_read_the_collections_stages():
    ring = {"tracks_s": 0.01, "pnp_s": 10.0, "local_ba_s": 6.0, "global_ba_s": 2.0}
    jobs = [{"stats": ring}, {"stats": dict(ring, pnp_s=12.0, global_ba_s=4.0)},
            {"stats": {"pnp_s": 1.0, "ba_s": 1.0, "add_views_s": 3.0}}]   # a host-loop job
    ctx = {"jobs": jobs, "events": None, "trace": None, "span": None, "calls": {}}
    assert _read("collection.pnp_s", ctx) == pytest.approx(11.0)
    assert _read("sparse.ba_s", ctx) == pytest.approx(9.0)
    host = dict(ctx, jobs=jobs[2:])
    assert _read("collection.pnp_s", host) is None and _read("sparse.ba_s", host) is None
