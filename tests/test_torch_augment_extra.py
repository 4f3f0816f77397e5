"""The port's extra augmentations == the JAX package's, with the JAX keys'
draws carried across (values atol 1e-5: the same homographies, float32
rounding of two implementations), and the port's own draws from a
``torch.Generator`` in range."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.ops import augment_extra as ja
from sinddm_tpu_torch.ops import augment_extra as ta

IMG = np.random.default_rng(0).uniform(0, 1, (23, 31, 3)).astype(np.float32)
KEYS = [jax.random.PRNGKey(k) for k in (0, 5, 11)]


@pytest.mark.parametrize("k", range(len(KEYS)))
def test_random_scale_matches_jax(k):
    key = KEYS[k]
    s = jax.random.uniform(key, minval=0.8, maxval=1.2)
    ours = ta.random_scale(torch.tensor(IMG), (19, 26), scale=float(s))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ja.random_scale(key, jnp.asarray(IMG), (19, 26))), atol=1e-5)


@pytest.mark.parametrize("k", range(len(KEYS)))
def test_random_size_crop_matches_jax(k):
    ks, ky, kx = jax.random.split(KEYS[k], 3)
    draws = dict(cover=float(jax.random.uniform(ks, minval=0.5, maxval=1.0)), uy=float(jax.random.uniform(ky)),
                 ux=float(jax.random.uniform(kx)))
    ours = ta.random_size_crop(torch.tensor(IMG), (20, 20), **draws)
    theirs = ja.random_size_crop(KEYS[k], jnp.asarray(IMG), (20, 20))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


@pytest.mark.parametrize("k", range(len(KEYS)))
def test_borderless_random_perspective_matches_jax(k):
    kx, ky = jax.random.split(KEYS[k])
    ours = ta.borderless_random_perspective(torch.tensor(IMG), 0.5, ux=np.array(jax.random.uniform(kx, (4,))),
                                            uy=np.array(jax.random.uniform(ky, (4,))))
    theirs = ja.borderless_random_perspective(KEYS[k], jnp.asarray(IMG), 0.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)
    assert ours.shape == IMG.shape


@pytest.mark.parametrize("d", [1, 4, 8, 16])
def test_divisible_crop_matches_jax(d):
    batch = np.stack([IMG, IMG[::-1]])
    for img in (IMG, batch):
        np.testing.assert_array_equal(ta.divisible_crop(torch.tensor(img), d).numpy(),
                                      np.asarray(ja.divisible_crop(jnp.asarray(img), d)))


@pytest.mark.parametrize("img", [(IMG * 255).astype(np.uint8), IMG, IMG[..., 0], (IMG[..., 0] * 255).astype(np.uint8)])
def test_to_tensor_safe_matches_jax(img):
    ours = ta.to_tensor_safe(img)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ja.to_tensor_safe(img)), atol=1e-7)
    assert ours.dtype == torch.float32 and ours.ndim == 3
    np.testing.assert_array_equal(ta.to_tensor_safe(torch.tensor(img)).numpy(), ours.numpy())


def test_generator_draws_are_seeded_and_in_range():
    img = torch.tensor(IMG)
    outs = [ta.random_size_crop(img, (16, 16), generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(*outs) and outs[0].shape == (16, 16, 3)
    out = ta.borderless_random_perspective(img, generator=torch.Generator().manual_seed(4))
    assert out.shape == img.shape and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    scaled = ta.random_scale(img, (23, 31), generator=torch.Generator().manual_seed(5))
    assert scaled.shape == (23, 31, 3) and torch.isfinite(scaled).all()
