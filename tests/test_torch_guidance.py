"""The port's CLIP guidance hook == the JAX package's, under the same draws.

``thresholded_grad`` (with a .5 tie of the 'nearest' quantile and a
zero-energy pixel) and the carry resize: atol 1e-6. One hook call against the
JAX hook, the JAX key's draws re-derived and fed in: x atol 1e-4 for all but
0.5% of the elements (a view pixel at a branch edge of the colour pipeline,
see ``assert_close_but_for_branch_flips``), 2e-2 for every element; the mask
equal except at most 0.5% of the pixels (an energy within rounding of the
quantile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.guidance import clip_extractor as jce
from sinddm_tpu.guidance import clip_guidance as jcg
from sinddm_tpu_torch.guidance import clip_extractor as tce
from sinddm_tpu_torch.guidance import clip_guidance as tcg
from torch_clip_draws import (
    assert_close_but_for_branch_flips,
    guidance_towers,
    loss_draws_from_key,
    one_torch_thread,  # noqa: F401  (fixture)
)

B, N_AUG, HW = 2, 2, (20, 27)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def extractors():
    jmod, variables, tmod = guidance_towers(seed=4)
    jex = jce.ClipExtractor(jmod, variables, n_aug=N_AUG, view_chunk=None)
    tex = tce.ClipExtractor(tmod, n_aug=N_AUG, view_chunk=1)
    text = np.random.default_rng(0).standard_normal((6, 32)).astype(np.float32)
    return jex, tex, text


@pytest.mark.parametrize("hw,quantile", [((9, 11), 0.8), ((8, 11), 0.5), ((9, 11), 0.0), ((6, 7), 0.7)])
def test_thresholded_grad_matches_jax(hw, quantile):
    """(8, 11) at q = 0.5 is a tie: the virtual index 0.5 * 87 = 43.5 rounds
    down in jnp and up in numpy / torch."""
    g = np.random.default_rng(1).standard_normal((2,) + hw + (3,)).astype(np.float32)
    g[0, 0, 0] = 0.0  # a zero-energy pixel: 0 / 0 must give 0, not NaN
    sparse, mask = tcg.thresholded_grad(torch.tensor(g), quantile)
    j_sparse, j_mask = jcg.thresholded_grad(jnp.asarray(g), quantile)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(j_sparse), atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert mask.shape == (2,) + hw + (1,) and mask.dtype == torch.bool
    assert torch.isfinite(sparse).all() and not mask[0, 0, 0]


@pytest.mark.parametrize("n", [2, 88, 99, 1000, 46128])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.7, 0.8, 1.0])
def test_nearest_quantile_index_matches_jnp(q, n):
    vals = jnp.arange(n, dtype=jnp.float32)
    assert tcg.nearest_quantile_index(q, n) == int(jnp.quantile(vals, q, method="nearest"))


@pytest.mark.parametrize("drop_mask", [False, True])
def test_carry_resize_matches_jax(drop_mask):
    rng = np.random.default_rng(2)
    mask = (rng.uniform(size=(B, 12, 16, 1)) > 0.5).astype(np.float32)
    prev = rng.uniform(-1, 1, (B, 12, 16, 3)).astype(np.float32)
    ours = tcg.resize_guidance_carry(tcg.ClipCarry(torch.tensor(mask), torch.tensor(prev), True), (17, 23), drop_mask)
    theirs = jcg.resize_guidance_carry(jcg.ClipCarry(jnp.asarray(mask), jnp.asarray(prev), jnp.asarray(True)), (17, 23), drop_mask)
    np.testing.assert_allclose(ours.mask.numpy(), np.asarray(theirs.mask), atol=1e-6)
    np.testing.assert_allclose(ours.x_recon_prev.numpy(), np.asarray(theirs.x_recon_prev), atol=1e-6)
    assert ours.has_mask is (not drop_mask) and bool(theirs.has_mask) is (not drop_mask)
    fresh = tcg.init_clip_carry(B, (5, 6), device="cpu")
    assert fresh.mask.shape == (B, 5, 6, 1) and fresh.x_recon_prev.shape == (B, 5, 6, 3) and fresh.has_mask is False


def test_hook_is_none_without_sub_iters_and_gated_at_the_finest_scale(extractors):
    _, tex, text = extractors
    kw = dict(n_scales=3, strength=0.3, quantile=0.7, llambda=0.2, stop_guidance=3)
    assert tcg.make_clip_guidance(tex, torch.tensor(text), s=1, sub_iters=0, **kw) is None

    def no_draws(batch, n_templates):
        raise AssertionError("a gated step must not draw")

    fn = tcg.make_clip_guidance(tex, torch.tensor(text), s=2, sub_iters=2, draw_fn=no_draws, **kw)
    x = torch.full((B,) + HW + (3,), 1.5)
    carry = tcg.init_clip_carry(B, HW, device="cpu")
    out, carry2, aux = fn(x, x, 2, 2, carry)  # t = 2 < stop_guidance at the finest scale
    assert out is x and carry2 is carry  # untouched: not even clamped
    assert torch.equal(aux["clip_score"], torch.zeros(2))


@pytest.mark.parametrize("has_mask,sub_iters", [(False, 1), (True, 2)])
def test_one_hook_call_matches_jax(extractors, has_mask, sub_iters):
    """The first-ever iteration (threshold, new mask), as every CLI mode runs
    it: one sub-iteration a step; and two sub-iterations on an existing mask
    (the blend branch). A second sub-iteration after a thresholded first one
    is not compared: the few pixels that differ after the first move the
    second one's gradient everywhere, by about the tolerance."""
    jex, tex, text = extractors
    rng = np.random.default_rng(5 + has_mask)
    x_recon = rng.uniform(-1.2, 1.2, (B,) + HW + (3,)).astype(np.float32)
    mask = (rng.uniform(size=(B,) + HW + (1,)) > 0.6).astype(np.float32) * has_mask
    prev = rng.uniform(-1, 1, (B,) + HW + (3,)).astype(np.float32) * has_mask
    kw = dict(s=1, n_scales=3, sub_iters=sub_iters, strength=0.3, quantile=0.7, llambda=0.2, stop_guidance=3)
    key = jax.random.PRNGKey(21)

    jfn = jcg.make_clip_guidance(jex, jnp.asarray(text), **kw)
    jx, jcarry, jaux = jax.jit(lambda xr, c: jfn(xr, xr, jnp.asarray(7), 1, key, c))(
        jnp.asarray(x_recon), jcg.ClipCarry(jnp.asarray(mask), jnp.asarray(prev), jnp.asarray(has_mask)))

    draws, k = [], key
    for _ in range(kw["sub_iters"]):  # the hook splits its key once a sub-iteration
        k, kl = jax.random.split(k)
        draws.append(loss_draws_from_key(kl, B, N_AUG, text.shape[0]))
    tfn = tcg.make_clip_guidance(tex, torch.tensor(text), draw_fn=lambda b, n: draws.pop(0), **kw)
    with torch.no_grad():
        tx, tcarry, taux = tfn(torch.tensor(x_recon), None, 7, 1,
                               tcg.ClipCarry(torch.tensor(mask), torch.tensor(prev), has_mask))
    assert not draws
    assert_close_but_for_branch_flips(tx.numpy(), jx, 1e-4, 0.005, 2e-2)
    assert float((tcarry.mask.numpy() != np.asarray(jcarry.mask)).mean()) <= 0.005
    assert tcarry.has_mask is True and bool(jcarry.has_mask)
    torch.testing.assert_close(tcarry.x_recon_prev, tx, atol=0, rtol=0)
    np.testing.assert_allclose(taux["clip_score"].numpy(), np.asarray(jaux["clip_score"]), rtol=1e-3)
    assert float(tx.abs().max()) <= 1.0
