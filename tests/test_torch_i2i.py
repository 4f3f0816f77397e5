"""Port ``image2image`` == ``sinddm_tpu.apps.i2i.image2image`` under replayed draws.

A dim-16 denoiser on a 3-scale pyramid, T = 20. The JAX function splits its
key once a run scale and hands the subkey to ``sample_via_scale``; those
draws are replayed into the port's ``noise_fn``. Tolerance atol 2e-4 on the
final composite and on every per-scale output, as for the port's walks.
Covered: harmonization with a mask at the finest scale (``custom_t`` indexed
by s), style transfer from ``n_scales - 2`` with ``sample_limited_t`` on an
input whose size is no pyramid size (histogram matching, the entry scale's
resize, the zeroed gamma row), omega 0 and 0.5. Where the dilated mask is
exactly 0 the composite is the input, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from sinddm_tpu.apps.i2i import image2image as jax_image2image
from sinddm_tpu.ops.image import dilate_mask as jax_dilate_mask
from sinddm_tpu_torch.apps.i2i import image2image
from torch_clip_draws import one_torch_thread  # noqa: F401  (fixture)
from torch_walk_draws import (
    BATCH,
    SCALE_FACTOR,
    SIZES_HW,
    NoiseQueue,
    replay_draws,
    tiny_models,
    tiny_pyramids,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def setup():
    return tiny_models()


def _i2i_draws(key, sched_j, hw_in, start_s, custom_t, sample_limited_t):
    """``image2image``'s draws: a subkey a run scale, at the input's size there."""
    n = len(SIZES_HW)
    draws = []
    for s in range(start_s, n):
        key, sub = jax.random.split(key)
        f = SCALE_FACTOR ** (n - s - 1)
        hw = (int(hw_in[0] / f), int(hw_in[1] / f))
        t_min = sched_j.num_timesteps_ideal[s + 1] if (sample_limited_t and s < n - 1) else 0
        draws += replay_draws(sub, (BATCH,) + hw + (3,), custom_t[s] - t_min)
    return draws


CASES = {
    # mode, input (H, W), start_s, custom_t, sample_limited_t, omega, with a mask
    "harmonization": ("harmonization", (40, 64), 2, [0, 0, 5], False, 0.0, True),
    "harmonization_omega": ("harmonization", (26, 30), 2, [0, 0, 4], False, 0.5, True),
    "style_transfer": ("style_transfer", (21, 29), 1, [0, 6, 5], True, 0.5, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image2image_matches_jax(setup, case):
    flax_model, params, sched_j, model, sched_t = setup
    mode, hw_in, start_s, custom_t, limited, omega, with_mask = CASES[case]
    rng = np.random.default_rng(11)
    input_img = rng.uniform(-1, 1, hw_in + (3,)).astype(np.float32)
    mask_img = None
    if with_mask:  # a box in the top-left corner, at another size than the input
        mask_img = np.zeros((hw_in[0] + 7, hw_in[1] - 5, 3), np.float32)
        mask_img[1:6, 2:8] = 1.0
    jpyr, tpyr = tiny_pyramids()
    key = jax.random.PRNGKey(5)
    kw = dict(mode=mode, mask_img=mask_img, start_s=start_s, custom_t=custom_t, batch_size=BATCH, omega=omega,
              sample_limited_t=limited)
    theirs_final, theirs = jax_image2image(flax_model, params, sched_j, jpyr, input_img, key, **kw)
    queue = NoiseQueue(_i2i_draws(key, sched_j, hw_in, start_s, custom_t, limited))
    aux = []
    final, outs = image2image(model, sched_t, tpyr, input_img, noise_fn=queue, device="cpu", collect_aux=aux,
                              collect_interm=True, **kw)
    assert not queue.q  # every draw consumed
    assert len(outs) == len(theirs) == len(aux) == len(SIZES_HW) - start_s
    for o, t in zip(outs, theirs):
        assert o.shape == t.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=2e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(theirs_final), atol=2e-4)
    assert final.shape == (BATCH,) + hw_in + (3,)
    for a, o in zip(aux, outs):
        torch.testing.assert_close(a["interm"][-1], o, rtol=0, atol=0)

    if with_mask:
        from PIL import Image

        m = Image.fromarray((mask_img * 255).astype(np.uint8)).resize(hw_in[::-1], Image.LANCZOS)
        dilated = jax_dilate_mask(np.asarray(m, np.float32) / 255.0, mode="harmonization")[:, :, 0]
        zero = dilated == 0.0
        assert zero.any()
        input01 = np.clip((input_img + np.float32(1.0)) * np.float32(0.5), 0.0, 1.0)
        for b in range(BATCH):
            np.testing.assert_array_equal(final[b].numpy()[zero], input01[zero])

