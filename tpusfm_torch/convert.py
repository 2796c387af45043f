"""Carry configuration and intermediate state from tpusfm to the port.

The port needs no learned weights: its only fixed table, the BRIEF
sampling pattern, is drawn from the same numpy generator (seed 42) as the
reference's. What crosses over is configuration and intermediate state,
as plain Python values and numpy arrays (this module imports nothing of
JAX), so stage tests can feed both packages identical inputs:

  * ``config_from_dict(dataclasses.asdict(tpusfm_cfg))`` -> SfMConfig
    (enums may arrive as members or by value);
  * ``features_from_numpy`` / ``matches_from_numpy`` -> tensors on a device;
  * ``engine_state_from_numpy`` -> the engine's EngineState;
  * ``pipeline_state_from_numpy`` / ``load_tpusfm_checkpoint`` -> the host
    loop's state (the arrays of ``SfMPipeline.save_checkpoint``, which has
    the same keys in both packages) into a port pipeline;
  * ``sparse_problem_from_numpy`` -> the COO bundle adjuster's problem;
  * ``collection_state_from_numpy`` -> the collection pipeline's host
    state at any stage boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tpusfm_torch.config import EssentialDecomposition, MatcherKind, SfMConfig
from tpusfm_torch.types import Features, Matches

_ENUMS = {"matcher": MatcherKind, "decomposition": EssentialDecomposition}


def config_from_dict(d: Mapping) -> SfMConfig:
    """SfMConfig from a tpusfm SfMConfig as a dict, field for field."""
    names = {f.name for f in dataclasses.fields(SfMConfig)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"fields not in tpusfm_torch.SfMConfig: {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        if k in _ENUMS:
            v = _ENUMS[k](getattr(v, "value", v))
        kw[k] = v
    return SfMConfig(**kw)


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def features_from_numpy(xy, desc, score, angle, valid, device="cpu") -> Features:
    return Features(xy=_t(xy, device, torch.float32), desc=_t(desc, device, torch.float32),
                    score=_t(score, device, torch.float32),
                    angle=_t(angle, device, torch.float32), valid=_t(valid, device, torch.bool))


def matches_from_numpy(idx, dist, valid, device="cpu") -> Matches:
    return Matches(idx=_t(idx, device, torch.int32), dist=_t(dist, device, torch.float32),
                   valid=_t(valid, device, torch.bool))


def engine_state_from_numpy(state: Mapping, device="cpu"):
    """EngineState from a mapping of the reference EngineState's fields
    (e.g. ``state._asdict()`` of tpusfm's, fetched to numpy)."""
    from tpusfm_torch.pipeline.engine import EngineState

    ints = {"obs", "feat2point", "n_points"}
    bools = {"pose_valid", "done", "good"}
    kw = {}
    for name in EngineState._fields:
        dt = torch.int64 if name in ints else torch.bool if name in bools else torch.float32
        kw[name] = _t(state[name], device, dt)
    return EngineState(**kw)


def pipeline_state_from_numpy(pipe, state: Mapping):
    """Put the reference pipeline's host state into the port's ``pipe``.

    ``state`` holds numpy arrays under the keys of ``save_checkpoint``:
    xyz, obs (the live prefix), feat2point, poses, pose_valid, done_views,
    good_views, K, and optionally feat_xy, feat_valid, feat_desc,
    feat_score, feat_angle, match_idx, match_valid, match_dist. Host arrays
    stay numpy; features become tensors on the pipeline's device."""
    pipe.load_state(state)
    return pipe


def load_tpusfm_checkpoint(pipe, path: str):
    """Load a checkpoint written by ``tpusfm``'s ``SfMPipeline.save_checkpoint``."""
    with np.load(path) as d:
        return pipeline_state_from_numpy(pipe, d)


def sparse_problem_from_numpy(cams, points, focal, cam_idx, pt_idx, uv, w, cam_free,
                              device="cpu", dtype=torch.float32):
    """SparseBAProblem from the fields of tpusfm's, as numpy arrays in its
    field order (``*(np.asarray(x) for x in jax_problem)``)."""
    from tpusfm_torch.ba.sparse import SparseBAProblem

    return SparseBAProblem(
        cams=_t(cams, device, dtype), points=_t(points, device, dtype),
        focal=_t(focal, device, dtype), cam_idx=_t(cam_idx, device, torch.int64),
        pt_idx=_t(pt_idx, device, torch.int64), uv=_t(uv, device, dtype),
        w=_t(w, device, dtype), cam_free=_t(cam_free, device, dtype))


_COLLECTION_STATE = ("feat_xy", "feat_valid", "match_idx", "match_valid", "obs_track",
                     "obs_view", "obs_feat", "obs_uv", "obs_alive", "node2track",
                     "track_xyz", "track_ok", "poses", "pose_valid")


def collection_state_from_numpy(pipe, state: Mapping):
    """Put a tpusfm ``CollectionPipeline``'s host state into the port's
    ``pipe`` at any stage boundary. ``state`` holds numpy arrays under the
    reference's attribute names: ``feat_xy``, ``feat_valid`` (after
    ``extract``), ``match_idx``, ``match_valid`` (after ``match``), and after
    ``build_tracks`` the ``obs_track/view/feat/uv/alive``, ``node2track``,
    ``track_xyz``, ``track_ok`` arrays, ``poses``, ``pose_valid`` and
    ``reg_order``; absent keys are left as they are. Everything stays host
    numpy, as in both packages; injected features count as extracted."""
    for name in _COLLECTION_STATE:
        if state.get(name) is not None:
            setattr(pipe, name, np.array(state[name]))
    if state.get("reg_order") is not None:
        pipe.reg_order = [int(v) for v in state["reg_order"]]
    if pipe.track_xyz is not None:
        pipe.T = len(pipe.track_xyz)
    if pipe.feat_xy is not None:
        pipe._extracted = True
    return pipe
