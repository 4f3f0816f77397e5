"""Port pyramid == JAX package pyramid: geometry and, on a synthetic image,
the images and the uint8-wraparound rescale losses."""

import numpy as np
import pytest
from PIL import Image

from sinddm_tpu import pyramid as jax_pyramid
from sinddm_tpu_torch import pyramid


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    # the tiny_pyramid pattern of tests/conftest.py
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (96, 128, 3)).astype(np.uint8)
    p = tmp_path_factory.mktemp("torch_pyr") / "tiny.png"
    Image.fromarray(img).save(p)
    return str(p)


def test_balloons_geometry_golden():
    capped, sizes_wh, factor, n = pyramid.compute_pyramid_geometry((248, 186))
    assert capped == (248, 186) and n == 5
    assert [(h, w) for w, h in sizes_wh] == [(48, 64), (67, 90), (94, 126), (133, 177), (186, 248)]
    assert abs(factor - 1.4030331316483415) < 1e-12


@pytest.mark.parametrize("size_wh", [(248, 186), (1000, 800), (128, 96), (640, 480), (300, 1200)])
@pytest.mark.parametrize("scale_factor", [1.411, 1.25])
def test_geometry_matches_jax(size_wh, scale_factor):
    ours = pyramid.compute_pyramid_geometry(size_wh, scale_factor=scale_factor)
    theirs = jax_pyramid.compute_pyramid_geometry(size_wh, scale_factor=scale_factor)
    assert ours[0] == theirs[0] and ours[1] == theirs[1] and ours[3] == theirs[3]
    assert ours[2] == theirs[2]


@pytest.mark.parametrize("exact_diff", [False, True])
def test_build_pyramid_matches_jax(image_path, exact_diff):
    ours = pyramid.build_pyramid(image_path, exact_diff=exact_diff)
    theirs = jax_pyramid.build_pyramid(image_path, exact_diff=exact_diff)
    assert ours.sizes_hw == theirs.sizes_hw and ours.sizes_wh == theirs.sizes_wh
    assert ours.n_scales == theirs.n_scales == 3
    assert ours.scale_factor == theirs.scale_factor
    np.testing.assert_allclose(ours.rescale_losses, theirs.rescale_losses, rtol=1e-12, atol=0)
    for a, b in zip(ours.images + ours.recon_images, theirs.images + theirs.recon_images):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_load_external_image_and_save_layout(image_path, tmp_path):
    np.testing.assert_array_equal(
        pyramid.load_external_image(image_path, auto_scale=5000),
        jax_pyramid.load_external_image(image_path, auto_scale=5000),
    )
    pyramid.build_pyramid(image_path, save_to=str(tmp_path))
    for s in range(3):
        assert (tmp_path / f"scale_{s}" / "tiny.png").exists()
        assert (tmp_path / f"scale_{s}_recon" / "tiny.png").exists() == (s > 0)
