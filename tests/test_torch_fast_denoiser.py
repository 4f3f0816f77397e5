"""Port's dot-formulated denoiser executor == the JAX package's
(``sinddm_tpu/models/fast_denoiser.py``), on the same seeded inputs and the
same parameters (``denoiser_from_flax``).

Tolerances: the conv pieces atol 1e-5 in fp32 and 1e-2 of max |ref| in bf16
(the two packages round the same bf16 operands, then sum in another order);
the whole dim-16 forward atol 2e-5 in fp32 (as the JAX package holds its
executor to flax's) and 2e-2 of max |ref| in bf16; the three-scale walk of
``tests/torch_walk_draws.py`` on the JAX walk's draws atol 2e-4 in fp32 (as
``test_full_walk_matches_jax``); in bf16 the two walks round apart as far
as a bf16 walk lies from the fp32 one, so each scale is held to 0.15
absolute on [-1, 1] and 0.01 in the mean (over seeds 3-10 the two packages'
bf16 walks read at most 0.097 and 0.0057 in the mean; the JAX bf16 walk
against its fp32 walk 0.098 and 0.0060).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu.apps.sampling import sample_scales as jax_sample_scales
from sinddm_tpu.apps.sampling import via_scale_size as jax_via_scale_size
from sinddm_tpu.models import fast_denoiser as jfd
from sinddm_tpu_torch.apps.sampling import make_model_fn, sample_scales
from sinddm_tpu_torch.models import fast_denoiser as tfd
from sinddm_tpu_torch.models.convert import denoiser_from_flax, random_flax_params
from torch_clip_draws import one_torch_thread  # noqa: F401
from torch_walk_draws import BATCH, SCALE_FACTOR, SIZES_HW, T, NoiseQueue, replay_draws, tiny_models

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
WALK_BOUNDS = {"fp32_dot": (2e-4, 2e-4), "bf16_dot": (0.15, 0.01)}  # max, mean |ours - theirs|


def _both(a, dtype):
    """A numpy array in each package's type (bf16 rounded alike in both)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(ours, theirs, dtype, atol_fp32, rel_bf16):
    ours, theirs = ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    if dtype == "fp32":
        np.testing.assert_allclose(ours, theirs, atol=atol_fp32, rtol=0)
    else:
        assert np.abs(ours - theirs).max() <= rel_bf16 * np.abs(theirs).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("piece", ["conv3x3", "conv1x1", "depthwise5x5"])
def test_conv_pieces_match_jax(piece, dtype):
    rng = np.random.default_rng(2)
    cin, cout = 8, 6
    x = rng.normal(size=(2, 10, 12, cin)).astype(np.float32)
    if piece == "depthwise5x5":
        w, b = rng.normal(size=(5, 5, cin)) * 0.2, rng.normal(size=(cin,))
        jfn, tfn = jfd.depthwise5x5_shifted, tfd.depthwise5x5_shifted
    else:
        k = 3 if piece == "conv3x3" else 1
        w, b = rng.normal(size=(k, k, cin, cout)) * 0.2, rng.normal(size=(cout,))
        jfn, tfn = jfd.conv2d_dot, tfd.conv2d_dot
    w, b = w.astype(np.float32), b.astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    theirs = jfn(jx, jw, jnp.asarray(b))
    ours = tfn(tx, tw, torch.from_numpy(b))
    assert ours.dtype == tx.dtype
    _close(ours, theirs, dtype, 1e-5, 1e-2)


@pytest.fixture(scope="module")
def net():
    params = random_flax_params(dim=16, seed=1)
    x = np.random.default_rng(0).normal(size=(2, 24, 28, 3)).astype(np.float32)
    return params, denoiser_from_flax(params, device="cpu"), x, np.array([3, 77])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(net, dtype):
    params, model, x, t = net
    jdt, tdt = DTYPES[dtype]
    jax_fn = jax.jit(jfd.apply_denoiser_dot, static_argnames="compute_dtype")
    theirs = jax_fn(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(2.0), compute_dtype=jdt)
    with torch.no_grad():
        ours = tfd.apply_denoiser_dot(model, torch.from_numpy(x), torch.from_numpy(t), 2.0, compute_dtype=tdt)
    assert ours.dtype == torch.float32
    _close(ours, theirs, dtype, 2e-5, 2e-2)


def test_fp32_forward_matches_the_model(net):
    _, model, x, t = net
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        ours = tfd.apply_denoiser_dot(model, x, t, 2.0, compute_dtype=torch.float32)
        ref = model(x, t, 2.0)
    torch.testing.assert_close(ours, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("fast_mode", sorted(WALK_BOUNDS))
def test_walk_matches_jax(fast_mode):
    """``sample_scales(make_model_fn(model, fast_mode))`` on the JAX walk's
    draws against the JAX ``sample_scales(..., fast_mode=)``."""
    flax_model, params, sched_j, model, sched_t = tiny_models()
    n = len(SIZES_HW)
    key = jax.random.PRNGKey(3)
    kw = dict(scale_factor=SCALE_FACTOR, n_scales=n, batch_size=BATCH, custom_sample=True)
    theirs = jax_sample_scales(flax_model, params, sched_j, SIZES_HW, key, fast_mode=fast_mode, **kw)
    draws, k = [], key
    for s in range(n):
        k, sub = jax.random.split(k)
        hw = SIZES_HW[0] if s == 0 else jax_via_scale_size(
            SIZES_HW, s=s, n_scales=n, scale_factor=SCALE_FACTOR, custom_sample=True, custom_img_size_idx=s)
        draws += replay_draws(sub, (BATCH,) + tuple(hw) + (3,), T if s == 0 else sched_j.num_timesteps_ideal[s])
    queue = NoiseQueue(draws)
    ours = sample_scales(make_model_fn(model, fast_mode), sched_t, SIZES_HW, noise_fn=queue, device="cpu", **kw)
    assert not queue.q
    max_bound, mean_bound = WALK_BOUNDS[fast_mode]
    for o, t in zip(ours, theirs):
        assert torch.isfinite(o).all()
        d = np.abs(o.numpy() - np.asarray(t))
        assert d.max() <= max_bound and d.mean() <= mean_bound, (d.max(), d.mean())


def test_make_model_fn_modes():
    _, _, _, model, _ = tiny_models()
    assert make_model_fn(model) is model
    with pytest.raises(ValueError, match="fast_mode"):
        make_model_fn(model, "fp16_dot")
