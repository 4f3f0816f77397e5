"""Port resizing == JAX package resizing (``jax.image.resize(linear,
antialias=False)`` vs ``F.interpolate(bilinear, align_corners=False)``),
up and down, atol 1e-5 (float32 interpolation weights)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.ops import resize as jax_resize
from sinddm_tpu_torch.ops import resize

CASES = [
    ((12, 16), (17, 23)),   # up, the pyramid walk's direction
    ((48, 64), (67, 90)),   # balloons scale 0 -> 1
    ((24, 32), (13, 19)),   # down (--scale_mul < 1)
    ((17, 23), (12, 16)),   # down
    ((9, 11), (9, 30)),     # up in W only
]


@pytest.mark.parametrize("src,dst", CASES)
def test_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).uniform(-1, 1, (2,) + src + (3,)).astype(np.float32)
    ours = resize.resize_bilinear(torch.from_numpy(x), dst).numpy()
    theirs = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), dst))
    assert ours.shape == (2,) + dst + (3,)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    hwc = resize.resize_bilinear(torch.from_numpy(x[0]), dst).numpy()
    np.testing.assert_allclose(hwc, theirs[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", CASES)
def test_nearest_matches_jax(src, dst):
    x = np.random.default_rng(1).uniform(-1, 1, (2,) + src + (3,)).astype(np.float32)
    ours = resize.resize_nearest(torch.from_numpy(x), dst).numpy()
    theirs = np.asarray(jax_resize.resize_nearest(jnp.asarray(x), dst))
    np.testing.assert_array_equal(ours, theirs)


def test_bilinear_rejects_other_ranks():
    with pytest.raises(ValueError):
        resize.resize_bilinear(torch.zeros(4, 4), (2, 2))
