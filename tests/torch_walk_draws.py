"""Shared test helper: the JAX sampler's normal draws, replayed from its key
and handed to the port through ``noise_fn`` in the same order; and the tiny
walk both packages run (a dim-16 denoiser, 3 scales, T = 20).

``sample_scale0`` / ``sample_via_scale`` split their key once for the
initial draw, then once a reverse step; with a guidance hook,
``p_sample_step`` splits the step's key again and draws the noise from the
first half (the hook gets the second).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sinddm_tpu.models import SinDDMNet as FlaxSinDDMNet
from sinddm_tpu.pyramid import Pyramid as JaxPyramid
from sinddm_tpu.schedules import make_schedules as jax_make_schedules
from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import make_schedules

T = 20
SIZES_HW = ((12, 16), (17, 23), (24, 32))
SCALE_LOSSES = (0.35, 0.2)
SCALE_FACTOR = 1.411
BATCH = 2


def tiny_pyramids():
    """The same seeded 3-scale pyramid as each package's ``Pyramid``."""
    rng = np.random.default_rng(3)
    images = tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in SIZES_HW)
    kw = dict(sizes_hw=SIZES_HW, sizes_wh=tuple((w, h) for h, w in SIZES_HW), images=images,
              recon_images=images, rescale_losses=SCALE_LOSSES, scale_factor=SCALE_FACTOR, n_scales=len(SIZES_HW))
    return JaxPyramid(**kw), Pyramid(**kw)


def tiny_models():
    """(flax model, its params, JAX schedules, the port's denoiser and
    schedules on the CPU), the same seeded dim-16 weights."""
    params = random_flax_params(dim=16, seed=7)
    sched_j = jax_make_schedules(timesteps=T, scale_losses=SCALE_LOSSES, n_scales=len(SIZES_HW))
    sched_t = make_schedules(timesteps=T, scale_losses=SCALE_LOSSES, n_scales=len(SIZES_HW), device="cpu")
    return FlaxSinDDMNet(dim=16), params, sched_j, denoiser_from_flax(params, device="cpu"), sched_t


def replay_draws(key, shape, n_steps, guided=False):
    """The draws of one scale: the initial one, then one a reverse step."""
    key, k0 = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(k0, shape, jnp.float32))]
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        if guided:
            sub, _ = jax.random.split(sub)
        draws.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return draws


class NoiseQueue:
    """A ``noise_fn`` that hands out the replayed draws in order."""

    def __init__(self, draws):
        self.q = [torch.tensor(a) for a in draws]

    def __call__(self, shape):
        t = self.q.pop(0)
        assert tuple(t.shape) == tuple(shape), (tuple(t.shape), tuple(shape))
        return t
