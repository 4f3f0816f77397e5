"""Port sampler == JAX package sampler, step for step, under injected noise.

The JAX sampler's normal draws are a pure function of its key (split
sequence: ``apps/sampling.py`` splits once per scale; ``sample_scale0`` /
``sample_via_scale`` split once for the initial draw, then once per
reverse step). They are replayed here on the host and handed to the port
through ``noise_fn`` in the same order. Tolerance atol 2e-4 over the whole
chain, as the JAX package holds itself to the reference sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.apps.sampling import sample_scales as jax_sample_scales
from sinddm_tpu.apps.sampling import via_scale_size as jax_via_scale_size
from sinddm_tpu.diffusion.core import sample_scale0 as jax_sample_scale0
from sinddm_tpu.diffusion.core import sample_via_scale as jax_sample_via_scale
from sinddm_tpu.models import SinDDMNet as FlaxSinDDMNet
from sinddm_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from sinddm_tpu.schedules import make_schedules as jax_make_schedules
from sinddm_tpu_torch.apps.sampling import sample_scales, via_scale_size
from sinddm_tpu_torch.diffusion.core import sample_scale0, sample_via_scale
from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
from sinddm_tpu_torch.ops.resize import resize_bilinear
from sinddm_tpu_torch.schedules import make_schedules

# tiny-but-real configuration: 3 scales, T=20, dim-16 denoiser
T = 20
N_SCALES = 3
SIZES_HW = [(12, 16), (17, 23), (24, 32)]
SCALE_LOSSES = [0.35, 0.2]
SCALE_FACTOR = 1.411
BATCH = 2


@pytest.fixture(scope="module")
def setup():
    params = random_flax_params(dim=16, seed=7)
    flax_model = FlaxSinDDMNet(dim=16)
    sched_j = jax_make_schedules(timesteps=T, scale_losses=SCALE_LOSSES, n_scales=N_SCALES)
    sched_t = make_schedules(timesteps=T, scale_losses=SCALE_LOSSES, n_scales=N_SCALES, device="cpu")
    model = denoiser_from_flax(params, device="cpu")
    jax_fn = lambda x, t, s: flax_model.apply({"params": params}, x, t, s)  # noqa: E731
    return flax_model, params, jax_fn, sched_j, model, sched_t


def _replay_draws(key, shape, n_steps):
    """The draws of one scale: the initial one, then one per reverse step."""
    key, k0 = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(k0, shape, jnp.float32))]
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return draws


class _NoiseQueue:
    def __init__(self, draws):
        self.q = [torch.tensor(a) for a in draws]

    def __call__(self, shape):
        t = self.q.pop(0)
        assert tuple(t.shape) == tuple(shape), (tuple(t.shape), tuple(shape))
        return t


def test_scale0_loop_matches_jax(setup):
    _, _, jax_fn, sched_j, model, sched_t = setup
    shape = (BATCH,) + SIZES_HW[0] + (3,)
    key = jax.random.PRNGKey(11)
    theirs, _, _ = jax_sample_scale0(jax_fn, sched_j, shape, key, s=0)
    queue = _NoiseQueue(_replay_draws(key, shape, T))
    with torch.no_grad():
        ours, _, _ = sample_scale0(model, sched_t, shape, noise_fn=queue, device="cpu")
    assert not queue.q  # every draw consumed
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-4)


@pytest.mark.parametrize("s,custom_t,omega", [(1, 12, 0.0), (2, 8, 0.5)])
def test_via_scale_loop_matches_jax(setup, s, custom_t, omega):
    """Reblur chain: deblend, custom posterior, and the omega variance
    (omega = 0 still adds exp(0.5 log 1e-20) * noise, as the JAX code does)."""
    _, _, jax_fn, sched_j, model, sched_t = setup
    base = np.random.default_rng(5).uniform(-1, 1, (BATCH,) + SIZES_HW[s - 1] + (3,)).astype(np.float32)
    shape = (BATCH,) + SIZES_HW[s] + (3,)
    key = jax.random.PRNGKey(100 + s)
    theirs, _, _ = jax_sample_via_scale(
        jax_fn, sched_j, jax_resize_bilinear(jnp.asarray(base), SIZES_HW[s]), key,
        s=s, total_t=custom_t, omega=omega,
    )
    queue = _NoiseQueue(_replay_draws(key, shape, custom_t))
    with torch.no_grad():
        ours, _, _ = sample_via_scale(
            model, sched_t, resize_bilinear(torch.from_numpy(base), SIZES_HW[s]),
            s=s, total_t=custom_t, omega=omega, noise_fn=queue,
        )
    assert not queue.q
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-4)


@pytest.mark.parametrize("sample_limited_t,omega", [(False, 0.0), (True, 0.5)])
def test_full_walk_matches_jax(setup, sample_limited_t, omega):
    flax_model, params, _, sched_j, model, sched_t = setup
    key = jax.random.PRNGKey(3)
    kw = dict(scale_factor=SCALE_FACTOR, n_scales=N_SCALES, batch_size=BATCH, custom_sample=True,
              sample_limited_t=sample_limited_t, omega=omega)
    theirs = jax_sample_scales(flax_model, params, sched_j, SIZES_HW, key, **kw)

    draws, k = [], key
    for s in range(N_SCALES):
        k, sub = jax.random.split(k)
        hw = SIZES_HW[0] if s == 0 else jax_via_scale_size(
            SIZES_HW, s=s, n_scales=N_SCALES, scale_factor=SCALE_FACTOR,
            custom_sample=True, custom_img_size_idx=s)
        t_start = T if s == 0 else sched_j.num_timesteps_ideal[s]
        t_min = sched_j.num_timesteps_ideal[s + 1] if (sample_limited_t and s < N_SCALES - 1) else 0
        draws += _replay_draws(sub, (BATCH,) + tuple(hw) + (3,), t_start - t_min)
    queue = _NoiseQueue(draws)
    aux = []
    ours = sample_scales(model, sched_t, SIZES_HW, noise_fn=queue, device="cpu",
                         collect_aux=aux, collect_interm=True, **kw)
    assert not queue.q
    assert len(ours) == len(theirs) == N_SCALES
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=2e-4)
    # collect_interm: every state, t descending, the last one the output
    for a, o in zip(aux, ours):
        torch.testing.assert_close(a["interm"][-1], o, rtol=0, atol=0)


@pytest.mark.parametrize("idx,scale_mul", [(1, (1.0, 1.0)), (4, (1.0, 1.0)), (2, (0.5, 1.5))])
def test_via_scale_size_matches_jax(idx, scale_mul):
    kw = dict(s=min(idx, N_SCALES - 1), n_scales=N_SCALES, scale_factor=SCALE_FACTOR,
              scale_mul=scale_mul, custom_sample=True, custom_img_size_idx=idx)
    assert via_scale_size(SIZES_HW, **kw) == jax_via_scale_size(SIZES_HW, **kw)


def test_start_image_injection(setup):
    _, _, _, _, model, sched_t = setup
    start = np.random.default_rng(9).uniform(-1, 1, SIZES_HW[1] + (3,)).astype(np.float32)
    outs = sample_scales(model, sched_t, SIZES_HW, scale_factor=SCALE_FACTOR, n_scales=N_SCALES,
                         batch_size=BATCH, custom_scales=[1, 2], start_noise=False,
                         start_image=start,
                         generator=torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(o.shape) for o in outs] == [(BATCH,) + SIZES_HW[1] + (3,), (BATCH,) + SIZES_HW[2] + (3,)]
    np.testing.assert_array_equal(outs[0][1].numpy(), start)
    assert torch.isfinite(outs[1]).all()
