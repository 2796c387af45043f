"""Parity of the port's detector/descriptor with tpusfm on the synthetic
dot-scene renders (tests/synthetic_scene.py).

Keypoint selection (valid), its order and the BRIEF descriptors are
compared exactly. Positions, scores and angles are compared to float32
round-off: XLA fuses the filters' multiply-adds into FMAs and evaluates
exp/atan2 with its own kernels, so the Harris surface differs by ~1e-7
relative, which moves a sub-pixel offset by < 1e-4 px.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic_scene import make_scene
from tpusfm.features import detect as jd
from tpusfm_torch.features import detect as td

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def images():
    imgs, _, _, _ = make_scene(n_views=2, n_dots=400)
    return imgs


@pytest.mark.parametrize("levels,sampling", [(4, "nearest"), (1, "bilinear")])
def test_extract_features_parity(images, levels, sampling):
    kw = dict(max_features=1024, pyramid_levels=levels, sampling=sampling)
    ref = jd.extract_features(jnp.asarray(images), **kw)
    port = td.extract_features(torch.as_tensor(images), **kw)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), valid)
    assert valid.sum() > 500
    np.testing.assert_array_equal(port.desc.numpy(), np.asarray(ref.desc))
    np.testing.assert_allclose(port.xy.numpy(), np.asarray(ref.xy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.score.numpy(), np.asarray(ref.score), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(port.angle.numpy()[valid], np.asarray(ref.angle)[valid],
                               rtol=0, atol=1e-4)


def test_extract_features_single_and_view(images):
    """extract_features_single on one image and Features.view on a batch
    give tpusfm's (1, F, ...) features."""
    kw = dict(max_features=256, pyramid_levels=1)
    ref = jd.extract_features_single(jnp.asarray(images[1]), **kw)
    port = td.extract_features_single(torch.as_tensor(images[1]), **kw)
    both = td.extract_features(torch.as_tensor(images), **kw)
    for name in ("xy", "desc", "score", "angle", "valid"):
        got, view, want = (getattr(port, name).numpy(), getattr(both.view(1), name).numpy(),
                           np.asarray(getattr(ref, name)))
        assert got.shape == view.shape == want.shape and got.shape[:2] == (1, 256)
        np.testing.assert_array_equal(view, got)
        np.testing.assert_array_equal(np.asarray(getattr(jd.extract_features(
            jnp.asarray(images), **kw).view(1), name)), want)
        if name in ("desc", "valid"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_brief_pattern_is_the_reference_table():
    np.testing.assert_array_equal(td._brief_pattern(256), jd._brief_pattern(256))


def test_detector_pieces(images):
    img = images[:1]
    thr = 20.0 / 255.0
    m_j, h_j = jd.fast_harris_maps(jnp.asarray(img[0]), thr)
    m_t, h_t = td.fast_harris_maps(torch.as_tensor(img), thr)
    np.testing.assert_array_equal(np.isfinite(m_t[0].numpy()), np.isfinite(np.asarray(m_j)))
    np.testing.assert_allclose(h_t[0].numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-9)
    nms_j = np.asarray(jd._nms3(m_j))
    nms_t = td._nms3(m_t)[0].numpy()
    np.testing.assert_array_equal(np.isfinite(nms_t), np.isfinite(nms_j))
    # wrap-around shift, as jnp.roll
    np.testing.assert_array_equal(td._shift2d(torch.as_tensor(img), 2, -3)[0].numpy(),
                                  np.asarray(jd._shift2d(jnp.asarray(img[0]), 2, -3)))
