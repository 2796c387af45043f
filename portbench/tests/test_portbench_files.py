"""Every file the harness finds by name loads, and BENCHMARK.json keeps to its
contract: a new cell, configuration, job kind, scene or metric is new files
and new entries, all found here."""
import glob
import json
import os
import re

import pytest

from portbench.run import HERE, ROOT, load_cell, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and 1 <= len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith(tuple(b["paths"]))
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as fh:
            conf = json.load(fh)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert {c for w in b["workloads"] for c in [w["config"]]} == set(names)
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for f in glob.glob(os.path.join(HERE, "**", "*"), recursive=True):
        rel = os.path.relpath(f, ROOT)
        if "__pycache__" not in rel:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in bench()["workloads"]:
        cell = load_cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(HERE, "workloads", "*.json"))))
def test_workload_files_load(path):
    name = os.path.basename(path)[:-5]
    cell = load_cell(name)
    wl = cell["workload"]
    assert wl["config"] == cell["config"]["name"]
    job = load_module("jobs", wl["job"])
    assert callable(job.run) and callable(job.make_config) and callable(job.reference_images)
    scene = load_module("scenes", cell["config"]["scene"]["kind"])
    assert callable(scene.make)
    assert set(wl["limits"]) == {"kp_miss", "desc_miss", "match_miss", "point_gap", "camera_gap"}
    assert wl["limits"]["match_miss"] == 0.0
    jobs = wl["jobs"]
    assert jobs and len(set(jobs)) == len(jobs) and all(isinstance(k, int) and k >= 0 for k in jobs)
    assert wl["pool"] >= 1 and isinstance(wl["scene_seed"], int)
    assert len(wl["why"]) <= 200
    job.make_config(cell)                     # the pipeline accepts every setting


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(HERE, "configs", "*.json"))))
def test_config_files_load(path):
    with open(path) as fh:
        conf = json.load(fh)
    for key in ("name", "source", "scene", "pipeline", "bars", "reduced", "assumed", "tiny"):
        assert key in conf, key
    # every key the configuration names at its top level agrees with what it runs
    for k, v in conf["pipeline"].items():
        if k in conf:
            assert conf[k] == v, k
    for k, v in conf["scene"].items():
        if k in conf and k != "kind":
            assert conf[k] == v, k


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    b = bench()
    readers = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(HERE, "metrics", "*.py"))
               if not p.endswith("__init__.py")}
    assert readers == {m["name"] for m in b["per_layer"]}
    for name in readers:
        mod = load_module("metrics", name)
        assert mod.read({"jobs": [], "trace": None, "events": None, "span": None,
                         "calls": {}}) is None


def test_span_readers_read_their_stage():
    jobs = [{"stats": {"solve_s": 2.0, "rank_s": 0.1, "prune_s": 0.5, "features_s": 0.1}},
            {"stats": {"solve_s": 4.0, "rank_s": 0.1, "prune_s": 0.7, "features_s": 0.3}}]
    ctx = {"jobs": jobs, "trace": None, "events": None, "span": None, "calls": {}}
    assert load_module("metrics", "engine.solve_s").read(ctx) == pytest.approx(3.0)
    assert load_module("metrics", "engine.prune_s").read(ctx) == pytest.approx(0.6)
    assert load_module("metrics", "features.extract_s").read(ctx) == pytest.approx(0.2)
    assert load_module("metrics", "hostloop.add_views_s").read(ctx) is None
    host = {"jobs": [{"stats": {"add_views_s": 1.0, "ba_s": 0.25, "features_s": 0.1}}],
            "trace": None, "events": None, "span": None, "calls": {}}
    assert load_module("metrics", "hostloop.add_views_s").read(host) == pytest.approx(1.0)
    assert load_module("metrics", "hostloop.ba_s").read(host) == pytest.approx(0.25)
    assert load_module("metrics", "engine.solve_s").read(host) is None
