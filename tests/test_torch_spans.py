"""The port's stage spans: ``tpusfm_torch.utils.profiling.stage`` around every
stage, add-view step, registration and LM iteration, on the profiler's clock.

Both paths run once on the 4-view dot scene under ``torch.profiler`` (CPU
activity): every span appears where it belongs (each host copy inside its
parent's), the fused engine makes V - 2 add-view steps, the host loop V - 2
registrations, and the stage timings keep their keys. The collection pipeline
runs a 10-view dot arc the same way: one ``sfm.run``, one
``sfm.collection.view`` per registration pass and one ``sfm.sparse.lm_iter``
per COO LM iteration, as its stats count them.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.synthetic_scene import make_scene
from tpusfm_torch import SfMConfig
from tpusfm_torch.pipeline import SfMPipeline
from tpusfm_torch.types import Intrinsics
from tpusfm_torch.utils.profiling import stage

torch.set_num_threads(1)
V = 4
CFG = dict(max_features=1024, max_matches=512, console_debug_level=5,
           min_point_count_for_homography=60)

# the stage timings each path reported before the spans, and the one they added
FUSED_STATS = {"features_s", "matching_s", "prune_s", "rank_s", "solve_s", "fetch_s",
               "total_s", "ba_iters"}
HOST_STATS = {"features_s", "matching_s", "prune_s", "baseline_s", "add_views_s", "pnp_s",
              "triangulate_s", "merge_s", "ba_s", "total_s", "ba_iters", "native",
              "find_2d3d_s"}

# span -> the spans one of whose host copies holds each of its host copies
FUSED_PARENTS = {
    "sfm.total": ("sfm.run",),
    **{f"sfm.{k}": ("sfm.total",) for k in ("features", "matching", "prune", "rank", "solve",
                                            "fetch")},
    **{f"sfm.engine.{k}": ("sfm.solve",) for k in ("baseline", "step", "finish")},
    "sfm.ba.lm_iter": ("sfm.engine.baseline", "sfm.engine.step", "sfm.engine.finish"),
}
HOST_PARENTS = {
    "sfm.total": ("sfm.run",),
    **{f"sfm.{k}": ("sfm.total",) for k in ("features", "matching", "prune", "baseline")},
    "sfm.hostloop.add_views": ("sfm.total",),
    "sfm.hostloop.view": ("sfm.hostloop.add_views",),
    **{f"sfm.hostloop.{k}": ("sfm.hostloop.view",) for k in ("find_2d3d", "pnp",
                                                             "triangulate", "merge")},
    "sfm.ba": ("sfm.baseline", "sfm.hostloop.view"),
    "sfm.ba.lm_iter": ("sfm.ba",),
}


def _traced_run(fused: bool):
    imgs, _, K, _ = make_scene(n_views=V, n_dots=400)
    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    pipe = SfMPipeline(imgs, SfMConfig(**CFG, fused=fused), intrinsics=intr, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = pipe.run()
    return rec, _sfm_spans(prof)


def _sfm_spans(prof):
    """{name: sorted [(start_ns, end_ns), ...]} of the session's ``sfm.*`` spans."""
    spans = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sfm."):
            # an operator's scope: no user annotation for the profiler to copy onto the device
            assert not e.is_user_annotation()
            spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in spans.items()}


@pytest.fixture(scope="module")
def fused():
    return _traced_run(True)


@pytest.fixture(scope="module")
def host():
    return _traced_run(False)


def _check_nesting(spans, parents):
    assert set(spans) == set(parents) | {"sfm.run"}
    assert len(spans["sfm.run"]) == 1 and len(spans["sfm.total"]) == 1
    for name, outer in parents.items():
        holders = [iv for p in outer for iv in spans[p]]
        for s, e in spans[name]:
            assert any(ps <= s and e <= pe for ps, pe in holders), (name, outer)


def test_fused_spans_nest_and_count_the_steps(fused):
    rec, spans = fused
    assert int(rec.pose_valid.sum()) >= V - 1
    _check_nesting(spans, FUSED_PARENTS)
    assert len(spans["sfm.engine.step"]) == V - 2
    assert len(spans["sfm.engine.baseline"]) == len(spans["sfm.engine.finish"]) == 1
    # the add-view steps run a fixed LM budget each
    per_step = [sum(ss <= s and e <= se for s, e in spans["sfm.ba.lm_iter"])
                for ss, se in spans["sfm.engine.step"]]
    assert len(set(per_step)) == 1 and per_step[0] >= 1


def test_host_loop_spans_nest_and_count_the_registrations(host):
    rec, spans = host
    assert int(rec.pose_valid.sum()) >= V - 1
    _check_nesting(spans, HOST_PARENTS)
    assert len(spans["sfm.hostloop.view"]) == len(spans["sfm.hostloop.find_2d3d"]) == V - 2
    # one LM iteration span per iteration the solves report
    assert len(spans["sfm.ba.lm_iter"]) == rec.stats["ba_iters"]


def test_stage_timings_keep_their_keys(fused, host):
    assert set(fused[0].stats) == FUSED_STATS
    assert set(host[0].stats) == HOST_STATS
    for rec in (fused[0], host[0]):
        # sfm.total holds every other stage: their timings fit in total_s
        assert all(v <= rec.stats["total_s"] for k, v in rec.stats.items()
                   if k.endswith("_s"))


def test_stage_without_a_profiler_enters_no_span(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    timings = {}
    with stage("sfm.test", timings, "test_s") as s:
        pass
    assert timings == {"test_s": s.seconds} and s.seconds >= 0.0


# --- the collection pipeline: a 10-view dot arc, a periodic global round every
# 3 registrations, so every kind of collection span opens at least once ---
COLLECTION_V = 10
COLLECTION_CFG = dict(max_features=512, max_matches=256, console_debug_level=5,
                      collection_window=3, collection_global_ba_interval=3,
                      ba_share_focal=False, ba_incremental_iterations=10, ba_max_iterations=20,
                      min_point_count_for_homography=60)
COLLECTION_PARENTS = {
    "sfm.total": ("sfm.run",),
    **{f"sfm.{k}": ("sfm.total",) for k in ("features", "matching", "prune")},
    "sfm.prune.chunk": ("sfm.prune",),
    "sfm.collection.tracks": ("sfm.total",),
    "sfm.collection.solve": ("sfm.total",),
    "sfm.baseline": ("sfm.collection.solve",),
    "sfm.collection.view": ("sfm.collection.solve",),
    "sfm.collection.pnp": ("sfm.collection.view",),
    # the baseline's and the global rounds' outside the views, the rest inside
    "sfm.collection.triangulate": ("sfm.collection.solve",),
    "sfm.collection.local_ba": ("sfm.collection.solve",),
    "sfm.collection.global_ba": ("sfm.collection.solve",),
    "sfm.sparse.lm_iter": ("sfm.collection.local_ba", "sfm.collection.global_ba"),
}


def _collection_run(profiled: bool):
    from tpusfm_torch.pipeline import CollectionPipeline
    from tpusfm_torch.tools.synthetic import make_collection

    imgs, _, K, _ = make_collection(n_views=COLLECTION_V, n_dots=350, arc_degrees=37.5,
                                   seed=3)
    pipe = CollectionPipeline(imgs, SfMConfig(**COLLECTION_CFG), device="cpu",
                              intrinsics=Intrinsics.create(float(K[0, 0]), float(K[0, 2]),
                                                           float(K[1, 2])))
    if not profiled:
        return pipe.run(), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = pipe.run()
    return rec, _sfm_spans(prof)


@pytest.fixture(scope="module")
def collection():
    return _collection_run(True)


def _inside(iv, holders):
    return sum(hs <= iv[0] and iv[1] <= he for hs, he in holders)


def test_collection_spans_nest_under_one_run(collection):
    rec, spans = collection
    assert int(rec.pose_valid.sum()) >= COLLECTION_V - 1
    _check_nesting(spans, COLLECTION_PARENTS)
    views = spans["sfm.collection.view"]
    # passes never overlap; each holds its PnP attempt, and the global rounds
    # (periodic, stall, final polish) lie outside every pass
    assert all(a[1] <= b[0] for a, b in zip(views, views[1:]))
    assert [_inside(p, views) for p in spans["sfm.collection.pnp"]] == [1] * len(views)
    assert not any(_inside(g, views) for g in spans["sfm.collection.global_ba"])
    assert rec.stats["global_rounds"] >= 1
    assert len(spans["sfm.collection.global_ba"]) == rec.stats["global_rounds"] + 2
    # every registered view's local BA inside its pass, the baseline's outside
    local_in = sum(_inside(b, views) for b in spans["sfm.collection.local_ba"])
    assert local_in == rec.stats["views_registered"]
    assert len(spans["sfm.collection.local_ba"]) == local_in + 1


def test_collection_view_spans_count_the_registration_passes(collection):
    rec, spans = collection
    st = rec.stats
    assert len(spans["sfm.collection.view"]) == st["views_tried"]
    assert st["views_registered"] == int(rec.pose_valid.sum()) - 2
    assert st["views_tried"] >= st["views_registered"] >= COLLECTION_V - 3


def test_sparse_lm_iteration_spans_count_the_iterations(collection):
    # every lm_solve_sparse call of the run goes through CollectionPipeline._ba,
    # which adds each solve's iterations into ba_iters
    rec, spans = collection
    assert len(spans["sfm.sparse.lm_iter"]) == rec.stats["ba_iters"] > 0
    assert rec.stats["ba_iters"] == rec.stats["ba_iters_local"] + rec.stats["ba_iters_global"]


def test_collection_without_a_profiler_enters_no_span_and_repeats(monkeypatch, collection):
    def refuse(name):
        raise AssertionError(f"a span {name!r} opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    rec, _ = _collection_run(False)
    traced = collection[0]
    # the spans change no arithmetic: the same outcome to the digit
    assert np.array_equal(rec.poses, traced.poses) and np.array_equal(rec.xyz, traced.xyz)
    assert {k: v for k, v in rec.stats.items() if not k.endswith("_s")} == {
        k: v for k, v in traced.stats.items() if not k.endswith("_s")}
