"""Port schedules == JAX package schedules (both cast from float64, atol 1e-6)."""

import numpy as np
import pytest
import torch

from sinddm_tpu.schedules import cosine_beta_schedule as jax_cosine
from sinddm_tpu.schedules import make_schedules as jax_make_schedules
from sinddm_tpu_torch.schedules import _BUFFERS, cosine_beta_schedule, make_schedules

# golden balloons rescale losses (tests/test_pyramid.py), uint8-wraparound semantics
BALLOONS_LOSSES = [1.0871835898797855, 0.7771932694518568, 0.5452509776707822,
                   0.3865868564044144]


@pytest.fixture(scope="module")
def pair():
    kw = dict(timesteps=100, scale_losses=BALLOONS_LOSSES, n_scales=5)
    return jax_make_schedules(**kw), make_schedules(device="cpu", **kw)


def test_cosine_schedule_equal():
    np.testing.assert_array_equal(cosine_beta_schedule(100), jax_cosine(100))


def test_every_buffer_matches_jax(pair):
    j, t = pair
    for name in _BUFFERS:
        ours = getattr(t, name)
        assert ours.dtype == torch.float32 and ours.device.type == "cpu", name
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(getattr(j, name)), atol=1e-6, rtol=0, err_msg=name
        )


def test_balloons_ideal_timesteps(pair):
    j, t = pair
    assert t.num_timesteps_ideal == (100, 52, 41, 31, 22) == j.num_timesteps_ideal
    assert t.num_timesteps_trained == j.num_timesteps_trained
    assert (t.num_timesteps, t.n_scales) == (100, 5)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_gammas_row_sampling(pair, s):
    j, t = pair
    row = t.gammas_row_sampling(s).numpy()
    np.testing.assert_allclose(row, np.asarray(j.gammas_row_sampling(s)), atol=1e-6, rtol=0)
    assert row.max() <= 0.55
    np.testing.assert_allclose(t.gammas_row(s).numpy(), np.asarray(j.gammas_row(s)), atol=1e-6)


def test_zero_gamma_row(pair):
    j, t = pair
    z = t.zero_gamma_row(4)
    np.testing.assert_array_equal(z.gammas.numpy(), np.asarray(j.zero_gamma_row(4).gammas))
    assert np.all(t.gammas[3].numpy() != 0)  # the original is untouched


def test_train_full_t_false_and_missing_losses():
    kw = dict(timesteps=100, scale_losses=[1.0, 0.5], n_scales=3, train_full_t=False)
    t = make_schedules(device="cpu", **kw)
    assert t.num_timesteps_trained == t.num_timesteps_ideal == jax_make_schedules(**kw).num_timesteps_ideal
    with pytest.raises(ValueError):
        make_schedules(timesteps=10, n_scales=2, device="cpu")
