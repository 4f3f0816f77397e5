"""The port's host image ops == the JAX package's (``sinddm_tpu/ops/image.py``).

``dilate_mask`` is rewritten without scipy (the dilation as shifted ORs, the
Gaussian as two 41-tap float64 passes summed in scipy's order), so it is
held to the scipy version at max abs 1e-7 on seeded masks: boxes inside or
touching the border, speckled, at 186x248 and on ragged frames (19x21,
97x131), in both modes.
``disk`` and ``match_histograms`` are the same numpy code and must be equal.
"""

import numpy as np
import pytest

from sinddm_tpu.ops import image as jimage
from sinddm_tpu_torch.ops import image as timage


def _mask(seed, hw, border):
    rng = np.random.default_rng(seed)
    h, w = hw
    m = np.zeros((h, w, 3), np.float32)
    bh, bw = rng.integers(1, h // 2 + 1), rng.integers(1, w // 2 + 1)
    y0 = h - bh if border else rng.integers(1, h - bh)
    x0 = rng.integers(0, w - bw + 1)
    m[y0 : y0 + bh, x0 : x0 + bw] = 1.0
    m[rng.random((h, w)) < 0.005] = 1.0  # speckles
    return m


@pytest.mark.parametrize("radius", [0, 1, 7, 20])
def test_disk_equals_jax(radius):
    np.testing.assert_array_equal(timage.disk(radius), jimage.disk(radius))


@pytest.mark.parametrize("mode", ["harmonization", "editing"])
@pytest.mark.parametrize("hw,border,seed", [((186, 248), False, 0), ((186, 248), True, 1), ((19, 21), False, 2),
                                            ((19, 21), True, 3), ((97, 131), True, 4)])
def test_dilate_mask_matches_scipy(mode, hw, border, seed):
    m = _mask(seed, hw, border)
    ours, theirs = timage.dilate_mask(m, mode), jimage.dilate_mask(m, mode)
    assert ours.shape == theirs.shape == hw + (1,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-7)
    # a dilation that covers the whole frame rescales 0 / 0, to nan in both packages
    assert np.isnan(ours).all() or (ours.min() == 0.0 and ours.max() == 1.0)


def test_dilate_mask_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown dilate mode"):
        timage.dilate_mask(np.zeros((4, 4, 1), np.float32), "blur")


@pytest.mark.parametrize("seed,hw_img,hw_ref", [(0, (40, 50), (30, 20)), (1, (182, 273), (186, 248))])
def test_match_histograms_equals_jax(seed, hw_img, hw_ref):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, hw_img + (3,), dtype=np.uint8)
    ref = np.clip(rng.normal(90, 30, hw_ref + (3,)), 0, 255).astype(np.uint8)
    ours = timage.match_histograms(img, ref)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, jimage.match_histograms(img, ref))
    with pytest.raises(ValueError, match="channel count"):
        timage.match_histograms(img, ref[..., :2])
