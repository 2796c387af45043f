"""Trace a split between tpusfm's and the port's strategy outcomes to its stage.

    python -m tests.crossfeed_strategies dump --package port|tpusfm --matchers of
        --seeds 0-11 --out-dir DIR [--device cuda]
    python -m tests.crossfeed_strategies compare A.npz B.npz
    python -m tests.crossfeed_strategies replay --matches A.npz [--loop-seed 5]
    python -m tests.crossfeed_strategies lk-gap [--seed 2] [--pair 0 1]
    python -m tests.crossfeed_strategies rates ref_of.jsonl port_of.jsonl
        [--fisher GOOD_A RUNS_A GOOD_B RUNS_B] [--bounds RATE RUNS LO HI]
    python -m tests.crossfeed_strategies draws --matchers dense --seeds 0-7 [--device cuda]
    python -m tests.crossfeed_strategies loop --package port|tpusfm --matches A.npz
        [--loop-seeds 0-7] [--device cpu] [--no-steps] [--log-level 2] [--out PATH]

``dump`` renders ``make_scene(n_views=7, h=768, w=1024, seed=s)`` and saves one
package's keypoints and its matches before the epipolar prune (what
``match()`` computes) as ``DIR/<package>_<matcher>_<s>.npz``. ``--package
port`` imports nothing of tpusfm and runs on ``--device`` (the card, by
default); ``--package tpusfm`` runs JAX on the CPU.

``compare`` holds two dumps pair by pair with ``test_flow_matchers``'
measures: the share of the first's valid (left, right) index pairs that the
second made too, and the largest gap of their distances on the common ones;
and the keypoints found in both (within 0.01 px).

``draws`` runs the port's ``SfMPipeline(...).run()`` on ``--device`` with
every RANSAC sample drawn from a CPU ``torch.Generator`` seeded as the
pipeline's (``tpusfm_torch.ransac.sample_indices`` swapped for this tool
only; the draws are then moved to the device), so a card run takes the CPU
run's minimal samples wherever its masks agree. One JSON line per run, the
keys of ``tools/strategy_seeds.py``.

``lk-gap`` measures how far LK's endpoints lie apart on one pair between
tpusfm, the port and the port in float64 (the arithmetic's resolution at
1024 px, against which the one-pair tests of ``test_torch_strategies.py``
set their distance tolerance).

``rates`` counts the runs in the bars per package, device and matcher in the
sweeps' JSON lines, and gives Fisher's one-sided test of two counts and the
chance that runs at a given rate fall outside given bounds.

``replay`` runs tpusfm's loop on a dump and solves every PnP and every
two-view + triangulation call of its add-view steps again, in both packages
on the inputs tpusfm had and the minimal samples it drew.

``loop`` loads a dump (either package's) into a pipeline after its
``match()`` and runs the rest of the host loop, as ``run()`` does:
``prune_matches_epipolar`` -> ``find_baseline_triangulation`` (which calls
``sort_views_for_baseline``) -> ``add_more_views``, once per loop seed (the
pipeline's seed; the render is the dump's). One JSON line per run: the
outcome with the keys of ``tests/reference_strategies.py``, the baseline
ranking's first three pairs and the pair that seeded the map, and for every
add-view step the 2D-3D count, the PnP inlier ratio and, for both packages
on that step's correspondences, the share of minimal PnP hypotheses that go
down ``pnp_dlt``'s reflected branch and the share that hold half of the
correspondences (see ``dlt_shares``).

Where another installed ``tests`` package shadows this directory, run it
from the repository's root as ``PYTHONPATH=. python
tests/crossfeed_strategies.py``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import types

import numpy as np

from tpusfm_torch.tools.strategy_seeds import OPERATING_POINT, outcome, parse_seeds
from tpusfm_torch.tools.synthetic import make_scene

PNP_THRESHOLD_PX = 10.0       # SfMConfig.pnp_threshold_px
DLT_SAMPLES = 256


def _jax_cpu():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def scene(seed: int):
    return make_scene(n_views=7, h=768, w=1024, seed=seed)


def _np(x) -> np.ndarray:
    """A torch tensor (any device) or a JAX array as numpy."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


# ---------------------------------------------------------------------------
# matches before the prune
# ---------------------------------------------------------------------------
def port_matches(imgs, K, matcher: str, device="cuda") -> dict:
    import torch

    from tpusfm_torch import MatcherKind, SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline
    from tpusfm_torch.types import Intrinsics

    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device=device)
    pipe = SfMPipeline(imgs, SfMConfig(**OPERATING_POINT, matcher=MatcherKind(matcher)),
                       intrinsics=intr, device=device)
    pipe.prune_matches_epipolar = lambda: None
    pipe.extract()
    pipe.match()
    return dict(feat_xy=pipe.feat_xy, feat_valid=pipe.feat_valid,
                feat_desc=pipe.features.desc.cpu().numpy(), match_idx=pipe.match_idx,
                match_valid=pipe.match_valid, match_dist=pipe.match_dist,
                pairs=np.array(pipe.pairs, np.int32),
                device=np.array(str(torch.device(device))))


def tpusfm_matches(imgs, K, matcher: str) -> dict:
    _jax_cpu()
    from tpusfm import SfMConfig
    from tpusfm.config import MatcherKind
    from tpusfm.pipeline import SfMPipeline
    from tpusfm.types import Intrinsics

    intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
    pipe = SfMPipeline(imgs, SfMConfig(**OPERATING_POINT, matcher=MatcherKind(matcher)),
                       intrinsics=intr)
    pipe.prune_matches_epipolar = lambda: None
    pipe.extract()
    pipe.match()
    return dict(feat_xy=pipe.feat_xy, feat_valid=pipe.feat_valid,
                feat_desc=np.asarray(pipe.features.desc), match_idx=pipe.match_idx,
                match_valid=pipe.match_valid, match_dist=pipe.match_dist,
                pairs=np.array(pipe.pairs, np.int32), device=np.array("cpu"))


def compare_dumps(a: dict, b: dict) -> dict:
    """Per pair: the share of a's valid (left, right) index pairs that b made
    too, the largest distance gap on the common ones, and per view the share
    of a's keypoints that b has within 0.01 px at the same index."""
    kp = []
    for v in range(a["feat_xy"].shape[0]):
        va = a["feat_valid"][v]
        gap = np.linalg.norm(a["feat_xy"][v] - b["feat_xy"][v], axis=-1)
        kp.append(float(((gap <= 0.01) & b["feat_valid"][v])[va].mean()))
    pairs = []
    for p, (i, j) in enumerate(a["pairs"].tolist()):
        da = {tuple(x): d for x, d in zip(a["match_idx"][p][a["match_valid"][p]].tolist(),
                                          a["match_dist"][p][a["match_valid"][p]])}
        db = {tuple(x): d for x, d in zip(b["match_idx"][p][b["match_valid"][p]].tolist(),
                                          b["match_dist"][p][b["match_valid"][p]])}
        common = da.keys() & db.keys()
        pairs.append({"pair": (i, j), "a": len(da), "b": len(db),
                      "same": len(common) / max(len(da), 1),
                      "gap": float(max((abs(da[k] - db[k]) for k in common), default=0.0))})
    return {"keypoints_same": kp, "pairs": pairs,
            "min_same": min(q["same"] for q in pairs),
            "max_gap": max(q["gap"] for q in pairs)}


# ---------------------------------------------------------------------------
# the share of minimal PnP hypotheses each package's DLT loses
# ---------------------------------------------------------------------------
def _reflected(module, name: str, solve):
    """(flags, solve()) where flags says, for every 12-vector that
    ``module.<name>`` (the DLT's null-vector routine) returns during
    ``solve()``, whether det(P[:, :3]) < 0: the reflected branch of
    ``pnp_dlt`` (a wrong R or a negated t)."""
    base = getattr(module, name)
    seen = []

    def rec(*a, **k):
        v = base(*a, **k)
        if v.shape[-1] == 12:
            m = _np(v).reshape(-1, 3, 4)[:, :, :3].astype(np.float64)
            seen.append(np.linalg.det(m) < 0)
        return v

    setattr(module, name, rec)
    try:
        result = solve()
    finally:
        setattr(module, name, base)
    return np.concatenate(seen), result


def dlt_shares(X, uv, Kinv, key_seed: int = 0) -> dict:
    """On one add-view step's 2D-3D correspondences (pixel uv, the step's
    Kinv): draw DLT_SAMPLES minimal samples of 6 with tpusfm's own sampler
    and solve each with both packages' ``pnp_dlt``. Per package, the share of
    hypotheses that go down the reflected branch (their null vector's sign
    gives det(P[:, :3]) < 0, each package's own routine: tpusfm's eigh, the
    port's inverse iteration from the all-ones vector), and the share whose
    solver output (DLT + 8 Gauss-Newton steps, as RANSAC scores it) holds at
    least half of all correspondences within the PnP threshold."""
    jax = _jax_cpu()
    import jax.numpy as jnp
    import torch

    from tpusfm.geometry import pnp as jpnp
    from tpusfm.ransac import _sample_indices
    from tpusfm_torch.geometry import pnp as tpnp

    X = np.asarray(X, np.float32)
    Kinv = np.asarray(Kinv, np.float64)
    x = (np.asarray(uv, np.float64) @ Kinv[:2, :2].T + Kinv[:2, 2]).astype(np.float32)
    idx = np.asarray(_sample_indices(jax.random.PRNGKey(key_seed),
                                     jnp.ones(len(X), bool), DLT_SAMPLES, 6))
    Xs, xs = X[idx], x[idx]

    def tpusfm_dlt():
        # one eager call per sample, so the recorder sees concrete arrays
        return np.stack([_np(jpnp.pnp_dlt(jnp.asarray(a), jnp.asarray(b))[0])
                         for a, b in zip(Xs, xs)])

    def port_dlt():
        return tpnp.pnp_dlt(torch.as_tensor(Xs), torch.as_tensor(xs))[0].numpy()

    ones = jnp.ones(6, jnp.float32)
    refine = {"tpusfm": lambda Rt: _np(jax.vmap(
                  lambda R, a, b: jpnp.refine_pose_gn(R, a, b, ones, iterations=8))(
                  jnp.asarray(Rt), jnp.asarray(Xs), jnp.asarray(xs))),
              "port": lambda Rt: tpnp.refine_pose_gn(
                  torch.as_tensor(Rt), torch.as_tensor(Xs), torch.as_tensor(xs),
                  torch.ones(Xs.shape[:2]), iterations=8).numpy()}
    out = {}
    for name, module, routine, solve in (
            ("tpusfm", jpnp, "smallest_singular_vector", tpusfm_dlt),
            ("port", tpnp, "smallest_eigenvector_psd", port_dlt)):
        flags, Rt0 = _reflected(module, routine, solve)
        Rt = refine[name](Rt0)
        pc = X[None] @ np.swapaxes(Rt[:, :, :3], -1, -2) + Rt[:, None, :, 3]
        z = pc[..., 2]
        err = np.linalg.norm(pc[..., :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[..., None]
                             - x[None], axis=-1) / Kinv[0, 0]
        inl = ((z > 0) & (err < PNP_THRESHOLD_PX)).mean(-1)
        out[name] = {"reflected": float(flags.mean()), "good": float((inl >= 0.5).mean())}
    return out


# ---------------------------------------------------------------------------
# the host loop on given matches
# ---------------------------------------------------------------------------
def run_with_cpu_draws(matcher: str, seed: int, device="cuda") -> dict:
    import torch

    from tpusfm_torch import ransac
    from tpusfm_torch.tools import strategy_seeds

    own = ransac.sample_indices
    cpu_gen = torch.Generator().manual_seed(seed)

    def cpu_draws(generator, mask, hypotheses, k):
        return own(cpu_gen, mask.cpu(), hypotheses, k).to(mask.device)

    ransac.sample_indices = cpu_draws
    try:
        imgs, gt_poses, K = scene(seed)
        return dict(strategy_seeds.run_one(imgs, gt_poses, K, matcher, seed, device),
                    draws="cpu generator")
    finally:
        ransac.sample_indices = own


def run_loop(package: str, d: dict, render_seed: int, loop_seed: int, matcher: str,
             device="cpu", log_level: int = 5, with_steps: bool = True,
             capture: list | None = None) -> dict:
    """One package's host loop from ``match()``'s output in ``d``; with
    ``capture``, appends the inputs of every PnP and triangulation call."""
    imgs, gt_poses, K = scene(render_seed)
    steps = []
    if package == "port":
        from tpusfm_torch import MatcherKind, SfMConfig
        from tpusfm_torch.pipeline import SfMPipeline
        from tpusfm_torch.types import Intrinsics

        intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]), device=device)
        kw = dict(device=device)
    else:
        _jax_cpu()
        from tpusfm import SfMConfig
        from tpusfm.config import MatcherKind
        from tpusfm.pipeline import SfMPipeline
        from tpusfm.types import Intrinsics

        intr = Intrinsics.create(float(K[0, 0]), float(K[0, 2]), float(K[1, 2]))
        kw = {}
    cfg = SfMConfig(**dict(OPERATING_POINT, console_debug_level=log_level),
                    matcher=MatcherKind(matcher))
    pipe = SfMPipeline(imgs, cfg, intrinsics=intr, seed=loop_seed, **kw)
    pipe.feat_xy = np.array(d["feat_xy"])
    pipe.feat_valid = np.array(d["feat_valid"])
    pipe.pairs = [tuple(p) for p in d["pairs"].tolist()]
    pipe.pair_of = {p: n for n, p in enumerate(pipe.pairs)}
    pipe.match_idx = np.array(d["match_idx"])
    pipe.match_valid = np.array(d["match_valid"])
    pipe.match_dist = np.array(d["match_dist"])
    pipe._lookup = None

    ranking = {}
    sort = pipe.sort_views_for_baseline

    def spied_sort():
        r = sort()
        ranking.setdefault("top", [(round(q, 4), tuple(p)) for q, p in r[:3]])
        return r

    pipe.sort_views_for_baseline = spied_sort
    name = "_pnp" if package == "port" else "_jit_pnp"
    pnp = getattr(pipe, name)

    def spied_pnp(key, X, uv, mask, K_, Kinv):
        res = pnp(key, X, uv, mask, K_, Kinv)
        m = _np(mask)
        steps.append({"X": _np(X)[m], "uv": _np(uv)[m], "Kinv": _np(Kinv),
                      "ratio": round(float(res.inlier_ratio), 4)})
        if capture is not None:
            capture.append(("pnp", dict(key=_np(key) if package == "tpusfm" else None, X=_np(X),
                                        uv=_np(uv), mask=m, K=_np(K_), Kinv=_np(Kinv),
                                        Rt=_np(res.Rt))))
        return res

    setattr(pipe, name, spied_pnp)
    if capture is not None:
        tname = "_prune_triangulate" if package == "port" else "_jit_prune_triangulate"
        tri = getattr(pipe, tname)

        def spied_tri(key, Rt_new, Rt_g, uv1, uv2, mask, K_, Kinv):
            out = tri(key, Rt_new, Rt_g, uv1, uv2, mask, K_, Kinv)
            capture.append(("triangulate", dict(
                key=_np(key) if package == "tpusfm" else None, Rt_new=_np(Rt_new),
                Rt_g=_np(Rt_g), uv1=_np(uv1), uv2=_np(uv2), mask=_np(mask), K=_np(K_),
                Kinv=_np(Kinv), keep=_np(out[1]))))
            return out

        setattr(pipe, tname, spied_tri)
    pipe.prune_matches_epipolar()
    seeded = pipe.find_baseline_triangulation()
    if seeded:
        base_pair = sorted(pipe.good_views)
        pipe.add_more_views()
    else:
        base_pair = None
    rec = types.SimpleNamespace(pose_valid=pipe.pose_valid, poses=pipe.poses,
                                num_points=pipe.n_points,
                                mean_reprojection_error=pipe.mean_reprojection_error(),
                                stats={})
    r = outcome(matcher, render_seed, rec, gt_poses)
    r.pop("stage_timings_s")
    r.pop("native")
    for s in steps:
        X, uv, Kinv = s.pop("X"), s.pop("uv"), s.pop("Kinv")
        s["n"] = len(X)
        if with_steps:
            s.update(dlt_shares(X, uv, Kinv))
    return dict(r, package=package, loop_seed=loop_seed,
                matches_from=str(d["source"]), baseline_top3=ranking.get("top"),
                baseline_pair=base_pair, steps=steps)


def replay(d: dict, loop_seed: int) -> list:
    """tpusfm's host loop on the dump ``d`` at ``loop_seed``, then every PnP
    and every two-view + triangulation slot of its add-view steps solved
    again from the same inputs by both packages, the port on the minimal
    samples tpusfm drew (``tpusfm.ransac._sample_indices`` from the call's
    key into ``sample_idx=``). One dict per call: the packages' inlier and
    kept counts; for PnP the poses' difference and the median reprojection
    error of tpusfm's pose at the focal of the call's K and at that of its
    Kinv."""
    jax = _jax_cpu()
    import jax.numpy as jnp
    import torch

    from tpusfm import SfMConfig
    from tpusfm.geometry import essential as jess
    from tpusfm.geometry import pnp as jpnp
    from tpusfm.geometry.triangulation import triangulate_views as jtri
    from tpusfm.ransac import _sample_indices, adaptive_num_hypotheses
    from tpusfm_torch.geometry import essential as tess
    from tpusfm_torch.geometry import pnp as tpnp
    from tpusfm_torch.geometry.triangulation import triangulate_views as ttri

    cfg = SfMConfig()
    e_hyp = max(cfg.ransac_hypotheses, adaptive_num_hypotheses(0.75, 8, cfg.essential_prob))
    pnp_hyp = max(cfg.pnp_hypotheses, adaptive_num_hypotheses(0.6, 6, cfg.pnp_confidence))
    tri_kw = dict(max_reprojection_error=cfg.min_reprojection_error,
                  iterations=cfg.triangulation_iters, eps=cfg.triangulation_eps)
    capture = []
    run_loop("tpusfm", d, int(d["seed"]), loop_seed, str(d["matcher"]), with_steps=False,
             capture=capture)
    T, J = torch.as_tensor, jnp.asarray
    out = []
    step = {"pnp": -1, "triangulate": -1}
    for kind, c in capture:
        step[kind] += 1
        f_K, f_Kinv = float(c["K"][0, 0]), float(1.0 / c["Kinv"][0, 0])
        if kind == "pnp":
            m = c["mask"]
            idx = _sample_indices(J(c["key"]), J(m), pnp_hyp, 6)
            args = [c[k] for k in ("X", "uv", "mask", "K", "Kinv")]
            kw = dict(threshold_px=cfg.pnp_threshold_px, hypotheses=pnp_hyp,
                      min_inlier_ratio=cfg.pose_inliers_minimal_ratio)
            rj = jax.jit(lambda *a: jpnp.find_camera_pose_2d3d(*a, **kw))(
                J(c["key"]), *map(J, args))
            rt = tpnp.find_camera_pose_2d3d(None, *map(T, args), **kw,
                                            sample_idx=T(np.asarray(idx)).long())
            Rj, Rt = _np(rj.Rt), rt.Rt.numpy()
            cos = (np.trace(Rj[:, :3].T @ Rt[:, :3]) - 1.0) / 2.0
            pc = c["X"][m] @ Rj[:, :3].T + Rj[:, 3]
            xn = pc[:, :2] / pc[:, 2:3]
            median_px = {name: float(np.median(np.linalg.norm(xn * f + pp - c["uv"][m], axis=1)))
                         for name, f, pp in (("K", f_K, c["K"][:2, 2]),
                                             ("Kinv", f_Kinv, -c["Kinv"][:2, 2] * f_Kinv))}
            out.append({"step": step[kind], "call": "pnp", "n": int(m.sum()),
                        "focal_K": f_K, "focal_Kinv": f_Kinv,
                        "inliers": [int(_np(rj.inliers).sum()), int(rt.inliers.sum())],
                        "rotation_deg": float(np.degrees(np.arccos(np.clip(cos, -1, 1)))),
                        "translation": float(np.linalg.norm(Rj[:, 3] - Rt[:, 3])),
                        "median_px_at_focal_of": median_px})
            continue
        keys = jax.random.split(J(c["key"]), c["uv1"].shape[0])
        for k in range(c["uv1"].shape[0]):
            m = c["mask"][k]
            if m.sum() < 8:
                continue
            idx = _sample_indices(keys[k], J(m), e_hyp, 8)
            uv1, uv2 = c["uv1"][k], c["uv2"][k]
            kw = dict(threshold_px=cfg.essential_threshold_px, hypotheses=e_hyp)
            rj = jax.jit(lambda *a: jess.find_camera_from_match(*a, **kw))(
                keys[k], J(uv1), J(uv2), J(m), J(c["K"]), J(c["Kinv"]))
            rt = tess.find_camera_from_match(None, T(uv1), T(uv2), T(m), T(c["K"]),
                                             T(c["Kinv"]), **kw,
                                             sample_idx=T(np.asarray(idx)).long())
            ij, it = _np(rj.inliers) & m, rt.inliers.numpy() & m
            kj = jtri(J(c["Rt_new"]), J(c["Rt_g"][k]), J(c["K"]), J(c["Kinv"]), J(uv1), J(uv2),
                      J(ij), **tri_kw)[1]
            kt = ttri(T(c["Rt_new"]), T(c["Rt_g"][k]), T(c["K"]), T(c["Kinv"]), T(uv1), T(uv2),
                      T(it), **tri_kw)[1]
            out.append({"step": step[kind], "call": "triangulate", "slot": k,
                        "matches": int(m.sum()), "focal_K": f_K, "focal_Kinv": f_Kinv,
                        "kept_in_run": int(c["keep"][k].sum()),
                        "epipolar_inliers": [int(ij.sum()), int(it.sum())],
                        "kept": [int(_np(kj).sum()), int(kt.numpy().sum())]})
    return out


def lk_gap(seed: int, pair) -> dict:
    """On one pair of the scene at ``seed``, with the port's single-scale
    keypoints at the operating point: the distance between LK endpoints of
    tpusfm, the port in float32 and the port in float64, over the keypoints
    both packages track (residual <= 25), as percentiles in px."""
    jax = _jax_cpu()
    import jax.numpy as jnp
    import torch

    from tpusfm.features import optical_flow as jof
    from tpusfm_torch import MatcherKind, SfMConfig
    from tpusfm_torch.features import optical_flow
    from tpusfm_torch.pipeline import SfMPipeline

    imgs = np.ascontiguousarray(scene(seed)[0][list(pair)])
    cfg = SfMConfig(max_features=OPERATING_POINT["max_features"],
                    matcher=MatcherKind.OPTICAL_FLOW)
    f = SfMPipeline(imgs, cfg, device="cpu")._extract(torch.as_tensor(imgs))
    xy, valid = f.xy.numpy()[0], f.valid.numpy()[0]
    je, jerr = (_np(x) for x in jax.jit(jof.track_points)(
        jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.asarray(xy)))
    ends = {}
    for dtype in (torch.float32, torch.float64):
        e, err = optical_flow.track_points(*(torch.as_tensor(a)[None].to(dtype)
                                             for a in (imgs[0], imgs[1], xy)))
        ends[dtype] = (e[0].numpy(), err[0].numpy())
    v = valid & (jerr <= 25) & (ends[torch.float32][1] <= 25)
    out = {"seed": seed, "pair": list(pair), "keypoints": int(v.sum())}
    for name, a, b in (("tpusfm-port", je, ends[torch.float32][0]),
                       ("tpusfm-float64", je, ends[torch.float64][0]),
                       ("port-float64", ends[torch.float32][0], ends[torch.float64][0])):
        d = np.linalg.norm(a - b, axis=1)[v]
        out[name] = {"p50": float(np.median(d)), "p99": float(np.percentile(d, 99)),
                     "max": float(d.max())}
    return out


def fisher_one_sided(good_a: int, n_a: int, good_b: int, n_b: int) -> float:
    """P(a's count of good runs >= good_a) when a and b share one rate and
    good_a + good_b good runs fall at random among the n_a + n_b (Fisher's
    exact test, one-sided)."""
    k, n = good_a + good_b, n_a + n_b
    return sum(math.comb(n_a, i) * math.comb(n_b, k - i)
               for i in range(good_a, min(k, n_a) + 1)) / math.comb(n, k)


def binomial_outside(p: float, n: int, lo: int, hi: int) -> float:
    """P(count < lo or count > hi) for n runs that each meet the bars with
    chance p."""
    return sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i)
               for i in range(n + 1) if not lo <= i <= hi)


def rates(paths) -> list:
    """Per (package, device, matcher) of JSON-line files written by
    ``tests/reference_strategies.py``, ``tools/strategy_seeds.py`` or
    ``draws``: the seeds in the bars and the count."""
    runs = {}
    for path in paths:
        for line in open(path):
            r = json.loads(line)
            if "cameras" not in r:
                continue
            device = "cpu" if r["device"].startswith("cpu") else "card"
            who = ("tpusfm" if os.path.basename(path).startswith("ref") else
                   "port, cpu draws" if r.get("draws") else "port")
            runs.setdefault((who, device, r["matcher"]), {})[r["seed"]] = r["meets_bars"]
    return [{"package": w, "device": dv, "matcher": m, "seeds": sorted(v),
             "in_bars": sorted(s for s, ok in v.items() if ok),
             "count": f"{sum(v.values())} of {len(v)}"}
            for (w, dv, m), v in sorted(runs.items())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("dump")
    a.add_argument("--package", choices=("port", "tpusfm"), required=True)
    a.add_argument("--matchers", default="of")
    a.add_argument("--seeds", default="0")
    a.add_argument("--out-dir", required=True)
    a.add_argument("--device", default="cuda")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--per-pair", action="store_true")
    lk = sub.add_parser("lk-gap")
    lk.add_argument("--seed", type=int, default=2)
    lk.add_argument("--pair", type=int, nargs=2, default=(0, 1))
    rt = sub.add_parser("rates")
    rt.add_argument("paths", nargs="+", help="JSON-line files of the sweeps (tpusfm's "
                                             "named ref*)")
    rt.add_argument("--fisher", nargs=4, type=int, action="append", default=[],
                    metavar=("GOOD_A", "RUNS_A", "GOOD_B", "RUNS_B"))
    rt.add_argument("--bounds", nargs=4, type=float, action="append", default=[],
                    metavar=("RATE", "RUNS", "LO", "HI"))
    rp = sub.add_parser("replay")
    rp.add_argument("--matches", required=True)
    rp.add_argument("--loop-seed", type=int, default=0)
    dr = sub.add_parser("draws")
    dr.add_argument("--matchers", default="dense")
    dr.add_argument("--seeds", default="0")
    dr.add_argument("--device", default="cuda")
    lp = sub.add_parser("loop")
    lp.add_argument("--package", choices=("port", "tpusfm"), required=True)
    lp.add_argument("--matches", required=True)
    lp.add_argument("--loop-seeds", default="0")
    lp.add_argument("--device", default="cpu")
    lp.add_argument("--no-steps", action="store_true", help="leave out the per-step shares")
    lp.add_argument("--log-level", type=int, default=5, help="the pipeline's console level")
    lp.add_argument("--out", help="also append the JSON lines here")
    args = ap.parse_args(argv)

    if args.cmd == "dump":
        os.makedirs(args.out_dir, exist_ok=True)
        for s in parse_seeds(args.seeds):
            imgs, _, K = scene(s)
            for m in args.matchers.split(","):
                d = (port_matches(imgs, K, m, args.device) if args.package == "port"
                     else tpusfm_matches(imgs, K, m))
                path = os.path.join(args.out_dir, f"{args.package}_{m}_{s}.npz")
                np.savez_compressed(path, seed=s, matcher=m, **d)
                print(json.dumps({"dump": path, "matches": int(d["match_valid"].sum())}),
                      flush=True)
        return 0
    if args.cmd == "draws":
        from tpusfm_torch.tools.common import device_and_card

        _, card = device_and_card(args.device)
        for s in parse_seeds(args.seeds):
            for m in args.matchers.split(","):
                print(json.dumps(dict(run_with_cpu_draws(m, s, args.device), device=card)),
                      flush=True)
        return 0
    if args.cmd == "lk-gap":
        print(json.dumps(lk_gap(args.seed, tuple(args.pair))), flush=True)
        return 0
    if args.cmd == "rates":
        for r in rates(args.paths):
            print(json.dumps(r), flush=True)
        for ga, na, gb, nb in args.fisher:
            print(json.dumps({"fisher_one_sided": [ga, na, gb, nb],
                              "p": fisher_one_sided(ga, na, gb, nb)}), flush=True)
        for p, n, lo, hi in args.bounds:
            print(json.dumps({"rate": p, "runs": int(n), "bounds": [int(lo), int(hi)],
                              "fails": binomial_outside(p, int(n), int(lo), int(hi))}),
                  flush=True)
        return 0
    if args.cmd == "replay":
        with np.load(args.matches) as f:
            d = dict(f, source=os.path.basename(args.matches))
        for r in replay(d, args.loop_seed):
            print(json.dumps(r), flush=True)
        return 0
    if args.cmd == "compare":
        with np.load(args.a) as fa, np.load(args.b) as fb:
            r = compare_dumps(dict(fa), dict(fb))
        if not args.per_pair:
            r.pop("pairs")
        print(json.dumps(dict(r, a=args.a, b=args.b)), flush=True)
        return 0
    with np.load(args.matches) as f:
        d = dict(f)
    d["source"] = os.path.basename(args.matches)
    for ls in parse_seeds(args.loop_seeds):
        r = run_loop(args.package, d, int(d["seed"]), ls, str(d["matcher"]), args.device,
                     args.log_level, not args.no_steps)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
