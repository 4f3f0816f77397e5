"""The port's CLIP extractor == the JAX package's, under the same draws.

The JAX pipeline's random numbers are re-derived from its key splits
(``tests/torch_clip_draws.py``) and fed to the port's apply functions:
homographies atol 1e-5 (relative to entries of O(1); the translation column
is O(100) pixels and is held to rtol 1e-5), views atol 1e-4, the loss
rtol 1e-3, its gradient 1e-3 of max |gradient| for all but 1% of the
elements and 3e-2 of it for every element (a view pixel at a branch edge of
the colour pipeline: see ``assert_close_but_for_branch_flips``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.guidance import clip_extractor as jce
from sinddm_tpu.ops import warp as jw
from sinddm_tpu_torch.guidance import clip_extractor as tce
from torch_clip_draws import (
    assert_close_but_for_branch_flips,
    guidance_towers,
    one_torch_thread,  # noqa: F401  (fixture)
    loss_draws_from_key,
    view_draws_from_key,
    view_draws_from_keys,
)

SRC_HW = (23, 31)
FRAME = (224, 301)
B, N_AUG = 2, 4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def towers():
    return guidance_towers(seed=2)


def _keys(seed):
    perk = [jax.random.split(k, 2 * N_AUG) for k in jax.random.split(jax.random.PRNGKey(seed), B)]
    return [p[:N_AUG] for p in perk], [p[N_AUG:] for p in perk]


def test_templates_and_frame_size_match_jax():
    assert tce.TEMPLATES_HR == jce.TEMPLATES_HR and tce.TEMPLATES_LR == jce.TEMPLATES_LR
    assert tce.compose_text_with_templates("x", tce.TEMPLATES_HR) == jce.compose_text_with_templates("x", jce.TEMPLATES_HR)
    for hw in [(186, 248), (23, 31), (300, 100), (64, 64), (100, 400)]:
        assert tce.resize_output_size(*hw) == jce.resize_output_size(*hw)
    assert tce.resize_output_size(*SRC_HW) == FRAME
    with pytest.raises(NotImplementedError):
        tce.get_augmentations_template("xx")


def test_homographies_match_jax():
    kcs, kas = _keys(0)
    d = view_draws_from_keys(kcs, kas)
    ours_aug = tce.augs_matrix(d, FRAME).numpy()
    ours = tce.view_matrices(d, range(N_AUG), SRC_HW, FRAME).numpy()
    h, w = SRC_HW
    for b in range(B):
        for v in range(N_AUG):
            m_aug, _ = jce._augs_matrix_and_color(kas[b][v], FRAME)
            np.testing.assert_allclose(ours_aug[b, v], np.asarray(m_aug), atol=1e-5, rtol=1e-5)
            s = float(d.crop_scale[b, v])
            crop_h, crop_w = np.floor(np.float32(h) * np.float32(s)), np.floor(np.float32(w) * np.float32(s))
            y0 = np.floor(np.float32(d.crop_uy[b, v]) * (h - crop_h + 1))
            x0 = np.floor(np.float32(d.crop_ux[b, v]) * (w - crop_w + 1))
            m_crop = (jw.crop_resize_matrix(0.0, 0.0, 1.0 * h, 1.0 * w, FRAME) if v == 0
                      else jw.crop_resize_matrix(y0, x0, crop_h, crop_w, FRAME))
            np.testing.assert_allclose(ours[b, v], np.asarray(m_crop @ m_aug), atol=1e-5, rtol=1e-5)
    # a chunk of views gives the same matrices as the whole set
    part = tce.view_matrices(d.views(2, 4), range(2, 4), SRC_HW, FRAME).numpy()
    np.testing.assert_array_equal(part, ours[:, 2:4])


def test_colour_pipeline_matches_jax():
    kcs, kas = _keys(1)
    d = view_draws_from_keys(kcs, kas)
    x = np.random.default_rng(0).uniform(0, 1, (B, N_AUG, 12, 14, 3)).astype(np.float32)
    ours = tce.apply_color(torch.tensor(x), d).numpy()
    seen = set()
    for b in range(B):
        for v in range(N_AUG):
            _, color_fn = jce._augs_matrix_and_color(kas[b][v], FRAME)
            np.testing.assert_allclose(ours[b, v], np.asarray(color_fn(jnp.asarray(x[b, v]))), atol=1e-5)
            seen.add((bool(d.jitter_u[b, v] < 0.7), bool(d.gray_u[b, v] < 0.15)))
    assert (True, False) in seen  # the draws exercise the jitter branch


def _views_match_jax(warp_precision):
    kcs, kas = _keys(2)
    d = view_draws_from_keys(kcs, kas)
    imgs = np.random.default_rng(1).uniform(0, 1, (B,) + SRC_HW + (3,)).astype(np.float32)
    ours = tce.augment_views(torch.tensor(imgs), d, range(N_AUG), fill=1.0, warp_precision=warp_precision)
    assert ours.shape == (B, N_AUG) + FRAME + (3,)
    for b in range(B):
        theirs = jce.augment_views_subset(kcs[b], kas[b], jnp.arange(N_AUG), jnp.asarray(imgs[b]), fill=1.0,
                                          mm_adjoint=True, warp_precision=warp_precision)
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs), atol=1e-4)


def test_views_match_jax():
    _views_match_jax(None)


def test_views_match_jax_at_warp_precision_high():
    """``warp_precision`` acts on the matrix-product warp only on a CUDA device."""
    _views_match_jax("high")


def test_text_embeddings_match_jax(towers):
    jmod, variables, tmod = towers
    ours = tce.ClipExtractor(tmod).get_text_embedding("Fire in the Forest", tce.TEMPLATES_HR)
    theirs = jce.ClipExtractor(jmod, variables).get_text_embedding("Fire in the Forest", jce.TEMPLATES_HR)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)
    avg = tce.ClipExtractor(tmod).get_text_embedding(["a", "b"], tce.TEMPLATES_HR[:2], average_embeddings=True)
    assert avg.shape == (1, 32)


def test_loss_and_gradient_match_jax(towers, view_chunk=2):
    jmod, variables, tmod = towers
    rng = np.random.default_rng(3)
    x01 = rng.uniform(0, 1, (B,) + SRC_HW + (3,)).astype(np.float32)
    text = rng.standard_normal((5, 32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jex = jce.ClipExtractor(jmod, variables, n_aug=N_AUG, view_chunk=view_chunk)
    j_loss, j_grad = jax.value_and_grad(lambda v: jex.calculate_clip_loss(v, jnp.asarray(text), key))(jnp.asarray(x01))

    tex = tce.ClipExtractor(tmod, n_aug=N_AUG, view_chunk=view_chunk)
    draws = loss_draws_from_key(key, B, N_AUG, 5)
    tx = torch.tensor(x01, requires_grad=True)
    loss = tex.calculate_clip_loss(tx, torch.tensor(text), draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-3)
    g_max = float(np.abs(np.asarray(j_grad)).max())
    assert_close_but_for_branch_flips(tx.grad.numpy(), j_grad, 1e-3 * g_max, 0.01, 3e-2 * g_max)

    with torch.no_grad():  # the chunk-by-chunk backward, as the sampler calls it
        loss2, grad2 = tex.clip_loss_and_grad(torch.tensor(x01), torch.tensor(text), draws)
    np.testing.assert_allclose(loss2.item(), loss.item(), rtol=1e-5)
    np.testing.assert_allclose(grad2.numpy(), tx.grad.numpy(), rtol=1e-4, atol=1e-7)


def test_embed_image_views_matches_jax_and_chunks_agree(towers):
    jmod, variables, tmod = towers
    x01 = np.random.default_rng(4).uniform(0, 1, (B,) + SRC_HW + (3,)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    theirs = jce.ClipExtractor(jmod, variables, n_aug=N_AUG, view_chunk=2).embed_image_views(jnp.asarray(x01), key)
    d = view_draws_from_key(key, B, N_AUG)
    with torch.no_grad():
        ours = tce.ClipExtractor(tmod, n_aug=N_AUG, view_chunk=2).embed_image_views(torch.tensor(x01), d)
        whole = tce.ClipExtractor(tmod, n_aug=N_AUG, view_chunk=None).embed_image_views(torch.tensor(x01), d)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)
    torch.testing.assert_close(ours, whole, atol=1e-5, rtol=0)


def test_draws_are_seeded_in_range_and_on_the_generators_device():
    g = torch.Generator().manual_seed(3)
    a = tce.draw_loss_params(3, 5, 14, g, "cpu")
    b = tce.draw_loss_params(3, 5, 14, torch.Generator().manual_seed(3), "cpu")
    for fa, fb in zip(a.views, b.views):
        assert torch.equal(fa, fb)
    v = a.views
    assert v.crop_scale.shape == (3, 5) and v.persp_dx.shape == (3, 5, 4) and v.perm.dtype == torch.int64
    assert (v.crop_scale >= 0.6).all() and (v.crop_scale <= 1.0).all()
    assert (v.angle.abs() <= 15).all() and (v.tx.abs() <= 0.1).all() and (v.hue.abs() <= 0.1).all()
    assert (v.jitter_f >= 0.9).all() and (v.jitter_f <= 1.1).all()
    assert torch.equal(v.perm.sort(-1).values, torch.arange(4).expand(3, 5, 4))
    assert 1 <= int(a.n_sel) <= 14 and a.idx.shape == (14,) and int(a.idx.max()) < 14
    ex = tce.ClipExtractor.__new__(tce.ClipExtractor)
    ex.n_aug, ex.view_chunk = 16, 8
    assert ex._chunk_size() == 8
    ex.view_chunk = 5
    assert ex._chunk_size() == 4
    ex.view_chunk = None
    assert ex._chunk_size() == 16
