"""Port ROI guidance == ``sinddm_tpu.guidance.roi`` and ``sinddm_tpu.apps.roi``.

The box helpers are numpy and must be equal. The hook (built on the
device, nearest-resized pastes blended with eta 0.8) must give the JAX
hook's output on one ``x_recon`` at each scale below the finest, be None
at the finest, and leave its input tensor as it was. The whole
``roi_guided_sampling`` walk matches the JAX one under replayed draws
(with a hook, the JAX step splits its key once more before the noise),
with two target boxes, at ``scale_mul`` (1, 1) and (1, 1.5): atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.apps.roi import roi_guided_sampling as jax_roi_guided_sampling
from sinddm_tpu.guidance import roi as jroi
from sinddm_tpu_torch.apps.roi import roi_guided_sampling
from sinddm_tpu_torch.guidance import roi as troi
from torch_clip_draws import one_torch_thread  # noqa: F401  (fixture)
from torch_walk_draws import (
    BATCH,
    SCALE_FACTOR,
    SIZES_HW,
    T,
    NoiseQueue,
    replay_draws,
    tiny_models,
    tiny_pyramids,
)

N = len(SIZES_HW)
TARGET = [4, 6, 8, 10]  # y x h w on the finest 24x32 image
BOXES = [[12, 16, 8, 12], [2, 20, 6, 8]]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("bb,s", [([4, 6, 8, 10], 0), ([13, 21, 9, 11], 1), ([0, 0, 24, 32], 2)])
def test_box_helpers_equal_jax(bb, s):
    assert troi.rescale_bb(bb, SCALE_FACTOR, N, s) == jroi.rescale_bb(bb, SCALE_FACTOR, N, s)
    img = np.random.default_rng(s).uniform(-1, 1, (24, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(troi.extract_patch(img, bb), jroi.extract_patch(img, bb))
    for ours, theirs in zip(troi.stat_from_bb(img, bb), jroi.stat_from_bb(img, bb)):
        assert ours.shape == (1, 1, 3)
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("s", range(N))
def test_hook_matches_jax_and_leaves_its_input(s):
    jpyr, tpyr = tiny_pyramids()
    kw = dict(scale_factor=SCALE_FACTOR, n_scales=N, s=s)
    ours = troi.make_roi_guidance(tpyr.images, TARGET, BOXES, device="cpu", **kw)
    theirs = jroi.make_roi_guidance(jpyr.images, TARGET, BOXES, **kw)
    if s == N - 1:
        assert ours is None and theirs is None
        return
    x = np.random.default_rng(10 + s).uniform(-1, 1, (BATCH,) + SIZES_HW[s] + (3,)).astype(np.float32)
    x_t = torch.from_numpy(x.copy())
    carry = object()
    out, out_carry, aux = ours(x_t, x_t, 3, s, carry)
    ref, _, _ = theirs(jnp.asarray(x), jnp.asarray(x), 3, s, jax.random.PRNGKey(0), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-7)
    assert out_carry is carry and aux == {}
    np.testing.assert_array_equal(x_t.numpy(), x)  # the caller's tensor is untouched
    assert not np.array_equal(out.numpy(), x)  # and the boxes did change the copy


@pytest.fixture(scope="module")
def setup():
    return tiny_models()


@pytest.mark.parametrize("scale_mul", [(1.0, 1.0), (1.0, 1.5)])
def test_roi_walk_matches_jax(setup, scale_mul):
    flax_model, params, sched_j, model, sched_t = setup
    jpyr, tpyr = tiny_pyramids()
    key = jax.random.PRNGKey(21)
    kw = dict(target_roi=TARGET, roi_bb_list=BOXES, batch_size=BATCH, scale_mul=scale_mul)
    theirs = jax_roi_guided_sampling(flax_model, params, sched_j, jpyr, key, **kw)

    draws, k = [], key
    for s in range(N):
        k, sub = jax.random.split(k)
        hw = (int(SIZES_HW[s][0] * scale_mul[0]), int(SIZES_HW[s][1] * scale_mul[1]))
        t_start = T if s == 0 else sched_j.num_timesteps_ideal[s]
        draws += replay_draws(sub, (BATCH,) + hw + (3,), t_start, guided=s < N - 1)
    queue = NoiseQueue(draws)
    ours = roi_guided_sampling(model, sched_t, tpyr, noise_fn=queue, device="cpu", **kw)
    assert not queue.q  # every draw consumed
    assert len(ours) == len(theirs) == N
    for o, t in zip(ours, theirs):
        assert o.shape == t.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=2e-4)
