"""The port's matcher strategies against tpusfm's, function by function.

The same inputs, made with numpy from a seed (the dot scene of
tests/synthetic_scene.py, 240x320, and keypoints from the detector), go
through each tpusfm function on the CPU and its counterpart in
``tpusfm_torch``. Tolerances:

  * ``l2_distance_matrix``: rtol 1e-5;
  * ``track_points``: endpoints within 1e-3 px and residuals within 1e-3
    (relative; they are on the 0..255 byte scale) on the valid keypoints
    (an invalid slot sits at (0, 0) in a flat window, where the damped
    solve amplifies round-off, and is masked by every caller);
  * the OF, dense and disparity matchers: the same (left, right) pairs on
    >= 99% of the valid matches, distances within 1e-4 on the common ones;
  * ``disparity_map``: disparities within 1e-4 + 1e-5 of their value where
    both are valid (the sub-pixel fit divides float32 round-off of the
    costs by the parabola's curvature), validity agreeing on >= 99.9% of
    the pixels;
  * ``estimate_similarity_2d``: within 1e-5, for an even and an odd count
    of seeds (``jnp.median`` averages the two middle values of an even
    count) and with one empty seed slot (the median is NaN, and the
    reweighting keeps every seed: a quirk of the reference the port keeps);
  * ``extract_blob_features``: positions within 1e-3 px and descriptors
    within 1e-4 on >= 99% of the keypoints.

Two tests hold the OF and dense matchers at the operating point's widths
(5120 keypoints, 2048 matches) on one pair of the 7-view 1024x768 textured
scene of ``chip_smoke.py`` (``tools/synthetic.py``; render seed 2, whose
pair (0, 1) seeds tpusfm's optical-flow reconstruction there): the same
pairs on >= 99% of the valid matches, as ``test_flow_matchers``, and
distances within 1e-3 px on the common ones, the endpoint tolerance of
``test_track_points``. (At coordinates of up to 1024 px a float32 spacing
is 6e-5 to 1.2e-4 px, and 80 LK iterations accumulate it: on this pair the
two packages' endpoints differ by 6.4e-4 px at the 99th percentile, and
each package's differ from a float64 run of the port by 1.2e-3 px,
``python -m tests.crossfeed_strategies lk-gap``; the 1e-4 of the 320-px dot
scene is below the arithmetic's resolution here.) The dense one first
holds the similarity that seeds the flow: the ratio-test descriptor matches
exactly, A and t within 1e-5 relative and 1e-4 absolute (sums of 256
float32 terms at up to 1024 px, in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tpusfm.features import blob as jblob
from tpusfm.features import dense as jdense
from tpusfm.features import match as jmatch
from tpusfm.features import optical_flow as jof
from tpusfm.features import stereo as jstereo
from tpusfm_torch.features import blob, dense, match, optical_flow, stereo
from tpusfm_torch.features.detect import extract_features
from tpusfm_torch.tools import synthetic

torch.set_num_threads(1)
PAIRS = [(0, 1), (1, 2)]
TEXTURED_SEED, TEXTURED_PAIR = 2, (0, 1)
OPERATING_POINT = dict(max_features=5120, max_matches=2048)
TEXTURED_GAP_PX = 1e-3


@pytest.fixture(scope="module")
def scene():
    """Images (3, 240, 320) and single-scale keypoints of the dot scene."""
    imgs = make_scene(n_views=3, n_dots=400, seed=0)[0]
    f = extract_features(torch.as_tensor(imgs), max_features=512, pyramid_levels=1)
    return imgs, f.xy.numpy(), f.valid.numpy(), f.desc.numpy()


def _pair_args(scene, a, b):
    """(jax args, torch args with a batch axis of one pair) of a matcher."""
    imgs, xy, valid, _ = scene
    arrays = (imgs[a], imgs[b], xy[a], valid[a], xy[b], valid[b])
    return (tuple(jnp.asarray(x) for x in arrays),
            tuple(torch.as_tensor(x)[None] for x in arrays))


def _same_matches(mj, mt):
    """Fraction of the reference's valid (left, right) pairs the port made too,
    and the largest distance gap on the pairs both made."""
    vj, vt = np.asarray(mj.valid), mt.valid[0].numpy()
    dj = {tuple(p): d for p, d in zip(np.asarray(mj.idx)[vj].tolist(), np.asarray(mj.dist)[vj])}
    dt = {tuple(p): d for p, d in zip(mt.idx[0].numpy()[vt].tolist(), mt.dist[0].numpy()[vt])}
    common = dj.keys() & dt.keys()
    assert len(dj) >= 10, "too few matches to compare"
    assert abs(len(dt) - len(dj)) <= 0.01 * len(dj)
    return len(common) / len(dj), max(abs(dj[k] - dt[k]) for k in common)


@pytest.mark.parametrize("f1,f2", [(64, 96), (200, 200)])
def test_l2_distance_matrix(f1, f2):
    rng = np.random.default_rng(f1)
    d1 = rng.normal(size=(f1, 64)).astype(np.float32)
    d2 = rng.normal(size=(f2, 64)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    want = np.asarray(jmatch.l2_distance_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = match.l2_distance_matrix(torch.as_tensor(d1), torch.as_tensor(d2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # and the L2 matcher on them: the same pairs, distances to 1e-5
    v1, v2 = rng.random(f1) > 0.1, rng.random(f2) > 0.1
    mj = jmatch.match_pair(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
                           ratio=0.9, max_matches=64, metric="l2")
    mt = match.match_pair(torch.as_tensor(d1), torch.as_tensor(v1), torch.as_tensor(d2),
                          torch.as_tensor(v2), ratio=0.9, max_matches=64, metric="l2")
    np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    np.testing.assert_allclose(mt.dist.numpy(), np.asarray(mj.dist), rtol=1e-5)


@pytest.mark.parametrize("pair", PAIRS)
def test_track_points(scene, pair):
    imgs, xy, valid, _ = scene
    a, b = pair
    je, jerr = jax.jit(jof.track_points)(jnp.asarray(imgs[a]), jnp.asarray(imgs[b]),
                                         jnp.asarray(xy[a]))
    te, terr = optical_flow.track_points(torch.as_tensor(imgs[a])[None],
                                         torch.as_tensor(imgs[b])[None],
                                         torch.as_tensor(xy[a])[None])
    v = valid[a]
    np.testing.assert_allclose(te[0].numpy()[v], np.asarray(je)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(terr[0].numpy()[v], np.asarray(jerr)[v], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", ["of", "dense", "stereo"])
@pytest.mark.parametrize("pair", PAIRS)
def test_flow_matchers(scene, kind, pair):
    jargs, targs = _pair_args(scene, *pair)
    desc = scene[3]
    if kind == "of":
        mj = jax.jit(functools.partial(jof.match_pair_optical_flow, max_matches=256))(*jargs)
        mt = optical_flow.match_pair_optical_flow(*targs, max_matches=256)
    elif kind == "dense":
        a, b = pair
        mj = jax.jit(functools.partial(jdense.match_pair_dense, max_matches=256))(
            *jargs, feats1_desc=jnp.asarray(desc[a]), feats2_desc=jnp.asarray(desc[b]))
        mt = dense.match_pair_dense(*targs, max_matches=256,
                                    feats1_desc=torch.as_tensor(desc[a])[None],
                                    feats2_desc=torch.as_tensor(desc[b])[None])
    else:
        # more slots than keypoints: the reference pads (stereo.py:143-148)
        mj = jax.jit(functools.partial(jstereo.match_pair_disparity, max_matches=600))(*jargs)
        mt = stereo.match_pair_disparity(*targs, max_matches=600)
        assert mt.idx.shape == (1, 600, 2) and not mt.valid[0, 512:].any()
    assert mt.idx.dtype == torch.int32 and mt.dist.dtype == torch.float32
    same, gap = _same_matches(mj, mt)
    assert same >= 0.99
    assert gap <= 1e-4


@pytest.mark.parametrize("pair", PAIRS)
def test_disparity_map(scene, pair):
    imgs = scene[0]
    a, b = pair
    dj, vj = jax.jit(jstereo.disparity_map)(jnp.asarray(imgs[a]), jnp.asarray(imgs[b]))
    dt, vt = stereo.disparity_map(torch.as_tensor(imgs[a])[None], torch.as_tensor(imgs[b])[None])
    dj, vj, dt, vt = np.asarray(dj), np.asarray(vj), dt[0].numpy(), vt[0].numpy()
    assert (vj == vt).mean() >= 0.999
    both = vj & vt
    assert both.sum() > 1000
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,empty", [(256, 0), (255, 0), (256, 1)])
def test_estimate_similarity_2d(n, empty):
    rng = np.random.default_rng(n + empty)
    xy1 = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    ang, s = 0.1, 1.05
    A = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    xy2 = (xy1 @ A.T + [4.0, -7.0] + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    xy2[:20] += rng.uniform(-40, 40, (20, 2)).astype(np.float32)           # outliers
    w = np.ones(n, bool)
    w[n // 2: n // 2 + empty] = False
    Aj, tj, okj = jdense.estimate_similarity_2d(jnp.asarray(xy1), jnp.asarray(xy2),
                                                jnp.asarray(w))
    At, tt, okt = dense.estimate_similarity_2d(torch.as_tensor(xy1)[None],
                                               torch.as_tensor(xy2)[None],
                                               torch.as_tensor(w)[None])
    np.testing.assert_allclose(At[0].numpy(), np.asarray(Aj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), rtol=1e-5, atol=1e-5)
    assert bool(okt[0]) == bool(okj)
    # the median itself, against jnp.median (an even count averages the two
    # middle values; any NaN gives NaN)
    r = np.where(w, np.linalg.norm(xy1 @ np.asarray(Aj).T + np.asarray(tj) - xy2, axis=1),
                 np.nan).astype(np.float32)
    np.testing.assert_equal(dense._median(torch.as_tensor(r)).numpy(),
                            np.asarray(jnp.median(jnp.asarray(r))))


def test_extract_blob_features(scene):
    imgs = scene[0]
    fj = jblob.extract_blob_features(jnp.asarray(imgs), max_features=512)
    ft = blob.extract_blob_features(torch.as_tensor(imgs), max_features=512)
    assert ft.desc.shape == (3, 512, 64) and ft.xy.shape == (3, 512, 2)
    n = close = 0
    for v in range(3):
        pj = np.asarray(fj.xy[v])[np.asarray(fj.valid[v])]
        dj = np.asarray(fj.desc[v])[np.asarray(fj.valid[v])]
        pt = ft.xy[v].numpy()[ft.valid[v].numpy()]
        dt = ft.desc[v].numpy()[ft.valid[v].numpy()]
        gap = np.linalg.norm(pj[:, None] - pt[None], axis=2)
        nn = gap.argmin(1)
        ok = (gap[np.arange(len(pj)), nn] <= 1e-3) & (np.abs(dj - dt[nn]).max(1) <= 1e-4)
        n += len(pj)
        close += int(ok.sum())
    assert n > 1000
    assert close >= 0.99 * n


@pytest.fixture(scope="module")
def textured_pair():
    """One pair of the 1024x768 textured scene and its single-scale
    keypoints, detected as the port's pipeline detects them for the flow
    strategies."""
    from tpusfm_torch import MatcherKind, SfMConfig
    from tpusfm_torch.pipeline import SfMPipeline

    imgs = synthetic.make_scene(n_views=7, h=768, w=1024, seed=TEXTURED_SEED)[0]
    imgs = np.ascontiguousarray(imgs[list(TEXTURED_PAIR)])
    cfg = SfMConfig(max_features=OPERATING_POINT["max_features"],
                    matcher=MatcherKind.OPTICAL_FLOW)
    f = SfMPipeline(imgs, cfg, device="cpu")._extract(torch.as_tensor(imgs))
    return imgs, f.xy.numpy(), f.valid.numpy(), f.desc.numpy()


def test_of_matches_textured_pair(textured_pair):
    imgs, xy, valid, _ = textured_pair
    arrays = (imgs[0], imgs[1], xy[0], valid[0], xy[1], valid[1])
    kw = dict(ratio=0.7, max_matches=OPERATING_POINT["max_matches"])   # match_ratio_flow
    mj = jax.jit(functools.partial(jof.match_pair_optical_flow, **kw))(
        *(jnp.asarray(x) for x in arrays))
    mt = optical_flow.match_pair_optical_flow(*(torch.as_tensor(x)[None] for x in arrays), **kw)
    same, gap = _same_matches(mj, mt)
    assert same >= 0.99
    assert gap <= TEXTURED_GAP_PX


def test_dense_matches_textured_pair(textured_pair):
    imgs, xy, valid, desc = textured_pair
    # the similarity seed: ratio-test descriptor matches, then the fit
    sj = jmatch.match_pair(jnp.asarray(desc[0]), jnp.asarray(valid[0]), jnp.asarray(desc[1]),
                           jnp.asarray(valid[1]), ratio=0.8, max_matches=256)
    st = match.match_pair(*(torch.as_tensor(x)[None] for x in (desc[0], valid[0], desc[1],
                                                               valid[1])),
                          ratio=0.8, max_matches=256)
    np.testing.assert_array_equal(st.valid[0].numpy(), np.asarray(sj.valid))
    np.testing.assert_array_equal(st.idx[0].numpy(), np.asarray(sj.idx))
    assert int(st.valid.sum()) >= 64
    li, ri = (np.maximum(np.asarray(sj.idx)[:, k], 0) for k in (0, 1))
    Aj, tj, okj = jdense.estimate_similarity_2d(jnp.asarray(xy[0][li]), jnp.asarray(xy[1][ri]),
                                                sj.valid)
    At, tt, okt = dense.estimate_similarity_2d(torch.as_tensor(xy[0][li])[None],
                                               torch.as_tensor(xy[1][ri])[None], st.valid)
    assert bool(okj) and bool(okt[0])
    np.testing.assert_allclose(At[0].numpy(), np.asarray(Aj), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), rtol=1e-5, atol=1e-4)
    # then the flow and the association
    arrays = (imgs[0], imgs[1], xy[0], valid[0], xy[1], valid[1])
    kw = dict(max_matches=OPERATING_POINT["max_matches"])
    mj = jax.jit(functools.partial(jdense.match_pair_dense, **kw))(
        *(jnp.asarray(x) for x in arrays), feats1_desc=jnp.asarray(desc[0]),
        feats2_desc=jnp.asarray(desc[1]))
    mt = dense.match_pair_dense(*(torch.as_tensor(x)[None] for x in arrays), **kw,
                                feats1_desc=torch.as_tensor(desc[0])[None],
                                feats2_desc=torch.as_tensor(desc[1])[None])
    same, gap = _same_matches(mj, mt)
    assert same >= 0.99
    assert gap <= TEXTURED_GAP_PX
