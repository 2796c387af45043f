"""The known-pose cell ``ring250.priors``: its rehearsal on the CPU at the
configuration's tiny sizes (a whole 32-view ring at the cell's own 256x192), a
fault in the known-pose path that the comparison must catch, the priors'
perturbation, the three readers on recorded events, and the job kind's exit on
a pipeline that takes no known poses."""
import numpy as np
import pytest
import torch

from portbench.run import load_module, load_cell, run_cell
from portbench.tests.test_portbench_spans import KINDS, _job

CELL = "ring250.priors"
SEED = 2**40 + 23


def _rehearse(**kw):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    return run_cell(CELL, SEED, 0.1, False, device="cpu", tiny=True, log=lambda m: None, **kw)


def test_the_priors_cell_rehearses_within_its_limits():
    res = _rehearse()
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0, res["checks"]
    assert all(c["value"] <= c["limit"] for c in res["checks"].values()), res["checks"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"


def test_the_global_solve_skipped_is_caught_by_the_camera_gap(monkeypatch):
    """The known-pose path with its final polish left out: the cameras stay
    at the perturbed priors."""
    from tpusfm_torch.pipeline import CollectionPipeline

    monkeypatch.setattr(CollectionPipeline, "_polish", lambda self: None)
    res = _rehearse()
    assert res["correct"] is False
    assert res["checks"]["camera_gap"]["value"] > res["checks"]["camera_gap"]["limit"]


def test_the_priors_are_the_true_poses_turned_and_moved_by_sigma():
    job = load_module("jobs", "priors")
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((500, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    poses = np.concatenate([q, rng.standard_normal((500, 3, 1))], 2).astype(np.float32)
    priors = job.perturb(poses, 5, 0.002)
    assert priors.dtype == np.float32 and np.array_equal(priors, job.perturb(poses, 5, 0.002))
    R = priors[:, :, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)
    # the turn's angle and the move's size: N(0, sigma^2) per axis
    dR = R @ poses[:, :, :3].transpose(0, 2, 1)
    angle = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert 0.0015 < np.sqrt(np.mean(angle ** 2) / 3) < 0.0025
    assert 0.0018 < np.std(priors[:, :, 3] - poses[:, :, 3]) < 0.0022
    assert not np.array_equal(priors, job.perturb(poses, 6, 0.002))


def test_make_config_exits_on_a_pipeline_without_known_poses(monkeypatch):
    from tpusfm_torch.pipeline import CollectionPipeline

    job = load_module("jobs", "priors")
    cell = load_cell(CELL, tiny=True)
    assert job.make_config(cell).collection_wraparound
    assert job.SIGMA == cell["config"]["prior_sigma"] == 0.002
    monkeypatch.setattr(CollectionPipeline, "run", lambda self: None)
    with pytest.raises(SystemExit, match="known_poses"):
        job.make_config(cell)


# --- the readers, on a recorded job: ``_job``'s five add-view steps renamed as
# the prune's calls (5 launches, 1 sync each) inside ``sfm.run`` ---
def _prune_job(kind="annotation", pairs=(256, 256, 128)):
    ctx = _job(kind=kind)
    ctx["events"] = [(n.replace("sfm.engine.step", "sfm.prune.chunk"), *rest)
                     for n, *rest in ctx["events"]]
    ctx["calls"] = {"match_top2": [(p, 1024, 1024) for p in pairs]}     # 640 pairs: 5 calls
    return ctx


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


@KINDS
def test_the_prune_readers_read_the_chunks(kind):
    ctx = _prune_job(kind)
    assert _read("prune.chunk_launches", ctx) == 5.0
    assert _read("prune.chunk_syncs", ctx) == 1.0
    assert _read("collection.view_launches", ctx) is None


@pytest.mark.parametrize("case", ["more_pairs", "fewer_pairs", "no_calls", "no_run", "no_events"])
def test_the_prune_readers_read_nothing_from_a_wrong_count(case):
    if case in ("more_pairs", "fewer_pairs"):         # 641 pairs need 6 calls, 512 need 4
        ctx = _prune_job(pairs=(256, 256, 129) if case == "more_pairs" else (256, 256))
    else:
        ctx = _prune_job()
        if case == "no_calls":
            ctx["calls"] = {}
        elif case == "no_run":
            ctx["events"] = [e for e in ctx["events"] if e[0] != "sfm.run"]
        else:
            ctx["events"] = None
    for name in ("prune.chunk_launches", "prune.chunk_syncs"):
        assert _read(name, ctx) is None, name


def test_the_known_pose_timing_reader():
    jobs = [{"stats": {"priors_s": 2.0, "tracks_s": 0.1}}, {"stats": {"priors_s": 3.0}},
            {"stats": {"solve_s": 5.0, "tracks_s": 0.1}}]          # an incremental job
    ctx = {"jobs": jobs, "events": None, "trace": None, "span": None, "calls": {}}
    assert _read("priors.solve_s", ctx) == pytest.approx(2.5)
    assert _read("priors.solve_s", dict(ctx, jobs=jobs[2:])) is None
