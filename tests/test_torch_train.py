"""The port's training slice against the JAX package's, on the CPU.

``p_losses``, the learning-rate schedule, the EMA, the scale draw and whole
train steps (loss, gradient, Adam, EMA) of ``sinddm_tpu_torch`` are held
against ``sinddm_tpu``'s on the same inputs: a 3-scale pyramid of 12x16 to
24x32 made here from a seed, dim 8, batch 2, with the timesteps and noise
drawn once with numpy and given to both packages (their RNG streams differ).

Tolerances: ``p_losses`` atol 1e-6 (the same fp32 arithmetic in another
order); lr(k) rtol 1e-6 (fp32 against float64 of the same power of two);
the EMA 1e-6 absolute on values of order 1; a train step's loss 1e-5
relative, the first step's gradients within 1e-5 of the largest gradient,
and every parameter's change over three steps within 1e-2 * lr
of the JAX package's, the EMA the same (the largest seen: 2.0e-3 * lr).
Adam divides by sqrt(v), so the changes are compared in units of lr, not
the raw gradients: where a gradient is near zero, its last bits move the
update by a share of lr.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sinddm_tpu import config as jax_config
from sinddm_tpu.diffusion.core import p_losses as jax_p_losses
from sinddm_tpu.models.denoiser import SinDDMNet as FlaxSinDDMNet
from sinddm_tpu.schedules import make_schedules as jax_make_schedules
from sinddm_tpu.training.trainer import _ema_update, make_lr_schedule, make_optimizer
from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
from sinddm_tpu_torch.diffusion.core import p_losses, training_loss
from sinddm_tpu_torch.models.convert import denoiser_params_from_flax, random_flax_params
from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.ops.conv_block import conv_block_reference, conv_block_train
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import make_schedules
from sinddm_tpu_torch.training.trainer import MultiscaleTrainer, TRUNC_STD, ema_update_

from torch_clip_draws import one_torch_thread  # noqa: F401

SIZES_HW = ((12, 16), (17, 23), (24, 32))
LOSSES = (0.31, 0.22)
DIM, BATCH = 8, 2


def _pyramid(seed=0):
    rng = np.random.default_rng(seed)
    images = tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in SIZES_HW)
    recon = (images[0],) + tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in SIZES_HW[1:])
    return Pyramid(sizes_hw=SIZES_HW, sizes_wh=tuple((w, h) for h, w in SIZES_HW), images=images,
                   recon_images=recon, rescale_losses=LOSSES, scale_factor=1.41, n_scales=3)


def _scheds():
    return (make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3, device="cpu"),
            jax_make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3))


def _trainer(tmp_path, cfg, seed=0):
    sched, _ = _scheds()
    return MultiscaleTrainer(SinDDMNet(dim=DIM, device="cpu"), sched, _pyramid(), cfg, DiffusionConfig(),
                             tmp_path, seed=seed, device="cpu")


def test_train_config_keeps_the_jax_defaults():
    """Every field, the chunk flags included; a fused_mode of neither kind is refused."""
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(jax_config.TrainConfig())
    with pytest.raises(ValueError, match="fused_mode"):
        TrainConfig(fused_mode="scan")


def _toy_models():
    """The same smooth model_fn in both packages (p_losses' own logic only)."""
    jf = lambda x, t, s: jnp.tanh(0.7 * x + 0.01 * t[:, None, None, None] + 0.1 * s)  # noqa: E731
    tf = lambda x, t, s: torch.tanh(0.7 * x + 0.01 * t[:, None, None, None] + 0.1 * s[:, None, None, None])  # noqa: E731
    return jf, tf


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("t0", [0, 37])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "l1_pred_img"])
def test_p_losses_matches_jax(loss_type, s, t0, masked):
    """All three loss types at s = 0 and s = 2 (the unclamped gamma row),
    with and without a valid mask, and with the batch's first timestep 0
    or not (l1_pred_img tests t[0] only)."""
    sched, jsched = _scheds()
    rng = np.random.default_rng(1)
    h, w = SIZES_HW[s]
    x_start = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    x_orig = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    noise = rng.standard_normal((3, h, w, 3)).astype(np.float32)
    t = np.asarray([t0, 99, 5])
    mask = (rng.uniform(size=(h, w, 1)) > 0.3).astype(np.float32) if masked else None
    jf, tf = _toy_models()
    theirs = jax_p_losses(jf, jsched, jnp.asarray(x_start), jnp.asarray(t), jnp.asarray(noise), s=s,
                          x_orig=jnp.asarray(x_orig) if s else None, loss_type=loss_type,
                          valid_mask=None if mask is None else jnp.asarray(mask))
    ours = p_losses(tf, sched, torch.tensor(x_start), torch.tensor(t), torch.tensor(noise), s=s,
                    x_orig=torch.tensor(x_orig) if s else None, loss_type=loss_type,
                    valid_mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(ours.item(), float(theirs), atol=1e-6, rtol=0)


def test_training_loss_draws_and_takes_injected_draws():
    """t ~ U[0, trained[s]) then the noise, from the generator; injected
    draws give p_losses of those draws."""
    sched, _ = _scheds()
    x_orig, x_blur = (torch.tensor(im)[None] for im in (_pyramid().images[1], _pyramid().recon_images[1]))
    _, tf = _toy_models()
    seen = {}

    def spy(x, t, s):
        seen["t"] = t
        return tf(x, t, s)

    gen = torch.Generator().manual_seed(3)
    a = training_loss(spy, sched, x_orig, x_blur, s=1, batch_size=64, generator=gen)
    assert seen["t"].shape == (64,) and 0 <= seen["t"].min() and seen["t"].max() < sched.num_timesteps_trained[1]
    gen = torch.Generator().manual_seed(3)
    t = torch.randint(0, sched.num_timesteps_trained[1], (64,), generator=gen)
    noise = torch.randn((64,) + tuple(x_orig.shape[1:]), generator=gen)
    b = training_loss(tf, sched, x_orig, x_blur, s=1, batch_size=64, t=t, noise=noise)
    c = p_losses(tf, sched, x_blur, t, noise, s=1, x_orig=x_orig)
    assert torch.equal(seen["t"], t) and a.item() == b.item() == c.item()


def test_lr_schedule_matches_make_lr_schedule_across_a_resume(tmp_path, one_torch_thread):  # noqa: F811
    """The learning rate of update k, k = 0 .. 34, milestones (10, 20, 30),
    is make_lr_schedule(k), also when the run is saved at k = 15 and resumed
    in a new trainer (the scheduler's and Adam's state restored), and in a
    grouped chunk of steps 26 .. 34, which crosses the milestone at 30."""
    cfg = TrainConfig(train_batch_size=1, train_lr=1e-3, sched_milestones=(10, 20, 30), lr_gamma=0.5)
    jax_lr = make_lr_schedule(jax_config.TrainConfig(train_lr=1e-3, sched_milestones=(10, 20, 30), lr_gamma=0.5))
    tr = _trainer(tmp_path, cfg)
    lrs = []
    for k in range(26):
        if k == 15:
            tr.save(1)
            tr = _trainer(tmp_path, cfg, seed=5)
            tr.load(-1)
            assert tr.step == 15
        lrs.append(tr.opt.param_groups[0]["lr"])
        tr.train_step(s=0)
    step = tr._step
    tr._step = lambda *args, **kw: (lrs.append(tr.opt.param_groups[0]["lr"]), step(*args, **kw))[1]
    tr.train_chunk_grouped(9)
    np.testing.assert_allclose(lrs, [float(jax_lr(k)) for k in range(35)], rtol=1e-6, atol=0)
    assert lrs[9] == 1e-3 and lrs[10] == 5e-4 and lrs[20] == 2.5e-4 and lrs[29] == 2.5e-4 and lrs[30] == 1.25e-4


def test_ema_matches_jax_over_25_steps():
    """step_start_ema 5, update_ema_every 3: hard copies at steps 0 and 3,
    lerps at 6, 9, ..., 24, unchanged in between."""
    cfg = TrainConfig(ema_decay=0.9, step_start_ema=5, update_ema_every=3)
    jcfg = jax_config.TrainConfig(ema_decay=0.9, step_start_ema=5, update_ema_every=3)
    ema = SinDDMNet(dim=DIM, device="cpu")
    model = SinDDMNet(dim=DIM, device="cpu")
    tree = random_flax_params(dim=DIM, seed=0)
    ema.load_state_dict(denoiser_params_from_flax(tree))
    jema = jax.tree.map(jnp.asarray, tree)
    for step in range(25):
        p = random_flax_params(dim=DIM, seed=100 + step)
        model.load_state_dict(denoiser_params_from_flax(p))
        ema_update_(ema, model, step, cfg)
        jema = _ema_update(jema, jax.tree.map(jnp.asarray, p), jnp.asarray(step), jcfg)
    theirs = denoiser_params_from_flax(jax.tree.map(np.asarray, jema))
    for k, v in ema.state_dict().items():
        torch.testing.assert_close(v, theirs[k], atol=1e-6, rtol=0)


def test_scale_draws_match_the_jax_trainer(tmp_path):
    """The port draws each step's scale as the JAX trainer's ``_rng`` does,
    for the same seed (uniform over the scales under train_full_t)."""
    from sinddm_tpu.config import DiffusionConfig as JaxDiffusionConfig
    from sinddm_tpu.pyramid import Pyramid as JaxPyramid
    from sinddm_tpu.training import MultiscaleTrainer as JaxTrainer

    pyr = _pyramid()
    sched, jsched = _scheds()
    flax_model = FlaxSinDDMNet(dim=DIM)
    # the trainer inits its parameters with model.init; jitted, that is one
    # compile instead of one for each of the init's operations
    model = types.SimpleNamespace(init=jax.jit(flax_model.init), apply=flax_model.apply)
    theirs = JaxTrainer(model, jsched, JaxPyramid(**dataclasses.asdict(pyr)),
                        jax_config.TrainConfig(train_batch_size=1), JaxDiffusionConfig(), str(tmp_path / "jax"),
                        seed=7)
    ours = MultiscaleTrainer(SinDDMNet(dim=DIM, device="cpu"), sched, pyr, TrainConfig(train_batch_size=1),
                             DiffusionConfig(), tmp_path / "torch", seed=7, device="cpu")
    np.testing.assert_array_equal(ours._s_probs, theirs._s_probs)
    a = [int(ours._rng.choice(len(ours._s_probs), p=ours._s_probs)) for _ in range(200)]
    b = [int(theirs._rng.choice(len(theirs._s_probs), p=theirs._s_probs)) for _ in range(200)]
    assert a == b and set(a) == {0, 1, 2}


def test_initial_parameters_follow_flax(tmp_path):
    """At dim 160: flax's shapes (its init's, through the converter), zero
    biases, and kernels of std sqrt(1 / fan_in) (a conv's kh * kw * Cin, the
    depthwise conv's 25, a Dense layer's input width): within 10% for each
    kernel of 1000 or more elements, within 10% over all kernels pooled
    (each divided by its sqrt(1 / fan_in)), and none past the truncation at
    2 / 0.8796 of it."""
    flax_params = jax.jit(FlaxSinDDMNet(dim=160).init)(jax.random.PRNGKey(0), jnp.zeros((1, 12, 16, 3)),
                                                       jnp.zeros((1,), jnp.int32), jnp.asarray(0.0))["params"]
    shapes = {k: tuple(v.shape) for k, v in denoiser_params_from_flax(jax.tree.map(np.asarray, flax_params)).items()}
    sched, _ = _scheds()
    tr = MultiscaleTrainer(SinDDMNet(dim=160, device="cpu"), sched, _pyramid(), TrainConfig(), DiffusionConfig(),
                           tmp_path, seed=0, device="cpu")
    state = tr.model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == shapes
    pooled = []
    for k, v in state.items():
        if k.endswith("bias"):
            assert not v.any(), k
            continue
        fan_in = v.shape[0] * v.shape[1] * v.shape[2] if v.ndim == 4 else v.shape[1]
        if k.endswith("ds_conv.weight"):
            assert fan_in == 25
        z = (v / fan_in ** -0.5).flatten()
        pooled.append(z)
        assert z.abs().max().item() <= 2.0 / TRUNC_STD + 1e-5, k
        if z.numel() >= 1000:
            assert abs(z.std().item() - 1.0) <= 0.1, (k, z.std().item())
    assert abs(torch.cat(pooled).std().item() - 1.0) <= 0.1
    assert torch.equal(tr.ema_model.state_dict()["l3.net_conv1.weight"], state["l3.net_conv1.weight"])


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's train step as its trainer runs it (``jax.value_and_grad`` of the
    mean of G ``p_losses`` on the flax module, ``make_optimizer``,
    ``_ema_update`` on the step before its increment), with the draws
    passed in, jitted once per (s, G); it returns the step's gradients too."""
    _, jsched = _scheds()
    model = FlaxSinDDMNet(dim=DIM)

    def make(cfg, s, G):
        opt = make_optimizer(cfg)

        @jax.jit
        def step_fn(params, opt_state, ema, step, x_orig, x_blur, ts, noises):
            def loss_fn(p):
                mf = lambda x, t, sc: model.apply({"params": p}, x, t, sc)  # noqa: E731
                losses = [jax_p_losses(mf, jsched, x_blur if s else x_orig, ts[g], noises[g], s=s,
                                       x_orig=x_orig if s else None) for g in range(G)]
                return jnp.mean(jnp.stack(losses))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, _ema_update(ema, params, step, cfg), loss, grads

        return opt, step_fn

    return make


def _close_in_lr(ours, theirs, start, lr, what):
    """Every parameter's change from ``start`` within 1e-2 * lr of the JAX
    package's."""
    for k, v in ours.items():
        d = ((v - start[k]) - (theirs[k] - start[k])).abs().max().item()
        assert d <= 1e-2 * lr, (what, k, d / lr)


@pytest.mark.parametrize("s", [0, 2])
@pytest.mark.parametrize("G", [1, 2])
def test_three_train_steps_match_jax(tmp_path, jax_steps, s, G, one_torch_thread):  # noqa: F811
    """Three steps at scale s with grad_accumulate G from the same parameters
    (random flax ones, carried across by ``models/convert.py``) and the same
    draws: the losses, the first step's gradients (Adam's update barely
    moves when every gradient is scaled alike, so a wrong scale shows only
    there), the parameters and the EMA (a hard copy at step 0, lerps at 1
    and 2)."""
    lr = 1e-3
    cfg = TrainConfig(train_batch_size=BATCH, grad_accumulate=G, train_lr=lr, step_start_ema=1,
                      update_ema_every=1, ema_decay=0.9)
    jcfg = jax_config.TrainConfig(train_batch_size=BATCH, grad_accumulate=G, train_lr=lr, step_start_ema=1,
                                  update_ema_every=1, ema_decay=0.9)
    opt, step_fn = jax_steps(jcfg, s, G)
    tree = random_flax_params(dim=DIM, seed=11)
    start = denoiser_params_from_flax(tree)
    tr = _trainer(tmp_path, cfg)
    tr.model.load_state_dict(start)
    tr.ema_model.load_state_dict(start)
    pyr = _pyramid()
    x_orig, x_blur = pyr.images[s][None], pyr.recon_images[s][None]
    params = jax.tree.map(jnp.asarray, tree)
    ema, opt_state = params, opt.init(params)
    rng = np.random.default_rng(20 + s + G)
    for step in range(3):
        ts = rng.integers(0, 100, (G, BATCH))
        noises = rng.standard_normal((G, BATCH) + x_orig.shape[1:]).astype(np.float32)
        params, opt_state, ema, jloss, jgrads = step_fn(params, opt_state, ema, jnp.asarray(step),
                                                        jnp.asarray(x_orig), jnp.asarray(x_blur), jnp.asarray(ts),
                                                        jnp.asarray(noises))
        loss = tr.train_step(s=s, t=list(torch.tensor(ts)), noise=list(torch.tensor(noises)))
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5, atol=0)
        if step == 0:  # from the same parameters: the gradients themselves, scale included
            theirs = denoiser_params_from_flax(jax.tree.map(np.asarray, jgrads))
            ours = {k: p.grad for k, p in tr.model.named_parameters()}
            assert ours.keys() == theirs.keys()
            g_max = max(g.abs().max().item() for g in theirs.values())
            g_err = max((ours[k] - theirs[k]).abs().max().item() for k in ours)
            assert g_err <= 1e-5 * g_max, g_err / g_max
    assert tr.step == 3
    theirs = denoiser_params_from_flax(jax.tree.map(np.asarray, params))
    _close_in_lr(tr.model.state_dict(), theirs, start, lr, "params")
    _close_in_lr(tr.ema_model.state_dict(), denoiser_params_from_flax(jax.tree.map(np.asarray, ema)), start, lr,
                 "ema")


def test_train_block_matches_the_plain_block():
    """The differentiable block computes the plain version's function (fp32,
    atol 2e-5 on outputs of order 1) and carries gradients to its input and
    every weight."""
    rng = np.random.default_rng(4)
    n = lambda *shape, scale=1.0: torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale)  # noqa: E731
    for c, co in ((3, 8), (8, 8)):
        args = [n(2, 9, 11, c), n(2, c, scale=0.2), n(5, 5, c, scale=0.2), n(c, scale=0.1),
                n(3, 3, c, co, scale=(9 * c) ** -0.5), n(co, scale=0.1), n(3, 3, co, co, scale=(9 * co) ** -0.5),
                n(co, scale=0.1), n(c, co, scale=c ** -0.5) if c != co else None, n(co, scale=0.1) if c != co else None]
        for a in args:
            if a is not None:
                a.requires_grad_(True)
        out = conv_block_train(*args)
        torch.testing.assert_close(out, conv_block_reference(*args), atol=2e-5, rtol=0)
        out.square().sum().backward()
        assert all(a.grad is not None and a.grad.abs().sum() > 0 for a in args if a is not None)


def test_trainer_refuses_what_it_does_not_train(tmp_path):
    """A model off the trainer's device, or not in float32, is refused,
    never moved or cast quietly."""
    sched, _ = _scheds()
    with pytest.raises(ValueError, match="lie on"):
        MultiscaleTrainer(SinDDMNet(dim=DIM, device="cpu"), sched, _pyramid(), TrainConfig(), DiffusionConfig(),
                          tmp_path, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        MultiscaleTrainer(SinDDMNet(dim=DIM, compute_dtype=torch.bfloat16, device="cpu"), sched, _pyramid(),
                          TrainConfig(), DiffusionConfig(), tmp_path, device="cpu")
