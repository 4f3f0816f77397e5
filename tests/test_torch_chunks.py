"""The port's training chunks (``--steps_per_chunk``, ``--fused_mode``) against the JAX package's, on the CPU.

On the CPU a chunk runs eagerly (the card replays CUDA graphs of the same
steps, held against this eager chunk by ``chip_smoke.py`` phase 8). Sizes are
``tests/test_torch_train.py``'s: a 3-scale pyramid of 12x16 to 24x32, dim 8,
batch 2.

* the grouped chunks of ``train()`` visit the JAX package's ``train()``'s
  (scale, steps) sub-chunks in its order, its own loop and ``_rng`` run with
  the step stubbed out, no compile;
* one padded step's loss and gradients against the JAX formula of
  ``_build_chunk_fn``'s ``one_loss``, written here from ``q_sample``,
  ``extract`` and ``SinDDMNet.apply(mask=)`` under ``jax.value_and_grad``,
  with the draws and the scale injected: loss 1e-5 relative, gradients
  within 1e-5 of the largest (``test_torch_train.py``'s bounds);
* a padded step equals the true-shape step on the same valid-region draws:
  loss 1e-6 relative, every gradient within 1e-6 of the largest (the same
  products; the canvas adds zeros and sums in another order); the block
  ``conv_block_train(mask=)`` against its crop: outputs 1e-6 absolute,
  each gradient within 1e-6 of its largest value;
* an eager grouped chunk equals the same steps through ``train_step``, bit
  for bit (the same code on the same draws: both trainers' generators are
  seeded alike and drawn in the same order), across an lr milestone and the
  EMA's warm-up boundary;
* ``l1_pred_img`` trains step by step in both modes;
* a checkpoint written after a chunk resumes the same chunks, bit for bit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sinddm_tpu import config as jax_config
from sinddm_tpu.config import DiffusionConfig as JaxDiffusionConfig
from sinddm_tpu.diffusion.core import extract as jax_extract, q_sample as jax_q_sample
from sinddm_tpu.models.denoiser import SinDDMNet as FlaxSinDDMNet
from sinddm_tpu.pyramid import Pyramid as JaxPyramid
from sinddm_tpu.training import MultiscaleTrainer as JaxTrainer
from sinddm_tpu.training.trainer import _stack_padded as jax_stack_padded
from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
from sinddm_tpu_torch.models.convert import denoiser_params_from_flax, random_flax_params
from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.ops.conv_block import conv_block_train
from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

from test_torch_train import BATCH, DIM, SIZES_HW, _pyramid, _scheds
from torch_clip_draws import one_torch_thread  # noqa: F401


def _trainer(tmp_path, cfg, loss_type="l1", seed=0):
    sched, _ = _scheds()
    return MultiscaleTrainer(SinDDMNet(dim=DIM, device="cpu"), sched, _pyramid(), cfg,
                             DiffusionConfig(loss_type=loss_type), tmp_path, seed=seed, device="cpu")


def _state(tr):
    """Everything a step changes: parameters, EMA, Adam's state, lr, step."""
    return {"params": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in tr.ema_model.state_dict().items()},
            "adam": {i: {k: v.clone() for k, v in st.items()} for i, st in tr.opt.state_dict()["state"].items()},
            "lr": tr.opt.param_groups[0]["lr"], "step": tr.step, "running_scale": list(tr.running_scale)}


def _assert_equal_states(a, b):
    assert (a["lr"], a["step"], a["running_scale"]) == (b["lr"], b["step"], b["running_scale"])
    for part in ("params", "ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    for i, st in a["adam"].items():
        for k, v in st.items():
            assert torch.equal(v, b["adam"][i][k]), ("adam", i, k)


def test_grouped_chunks_visit_what_the_jax_train_visits(tmp_path, one_torch_thread):  # noqa: F811
    """250 steps, chunks of 100, a checkpoint every 120: chunks of 100, 20,
    100, 20, 10 steps, each as (scale, steps) sub-chunks in the order of
    ``_rng.permutation`` (seed 7), the same in both packages' ``train()``."""
    cfg = dict(train_batch_size=1, train_num_steps=250, steps_per_chunk=100, save_and_sample_every=120)
    pyr = _pyramid()
    _, jsched = _scheds()
    # the JAX trainer with one stand-in parameter: its loop never reads them
    model = types.SimpleNamespace(init=lambda *args: {"params": {"w": jnp.zeros((1,))}}, apply=None)
    theirs_tr = JaxTrainer(model, jsched, JaxPyramid(**dataclasses.asdict(pyr)), jax_config.TrainConfig(**cfg),
                           JaxDiffusionConfig(), str(tmp_path / "jax"), seed=7)
    theirs = []

    def record(state, x_orig, x_blur, key, s, n_steps):
        theirs.append((s, n_steps))
        return state.replace(step=state.step + n_steps), np.zeros((n_steps,), np.float32)

    theirs_tr._scale_chunk_fn = record
    theirs_tr.save = lambda milestone: None
    theirs_tr.train(fused=True, log_fn=lambda _: None)

    ours_tr = _trainer(tmp_path / "torch", TrainConfig(**cfg), seed=7)
    ours_tr._step = lambda s, t=None, noise=None: (torch.zeros(()), None)  # the visits, not the steps
    ours_tr.save = lambda milestone: None
    ours = []
    run_scale = ours_tr.train_scale
    ours_tr.train_scale = lambda s, k: (ours.append((s, k)), run_scale(s, k))[1]
    ours_tr.train(log_fn=lambda _: None)
    assert ours == theirs and len(ours) == 15
    assert [k for _, k in ours] == [33, 33, 34, 6, 6, 8, 33, 33, 34, 6, 6, 8, 3, 3, 4]
    assert ours_tr.step == 250 and ours_tr.running_scale == theirs_tr.running_scale == sum(
        ([s] * k for s, k in theirs), [])


@pytest.fixture(scope="module")
def jax_padded_step():
    """The JAX trainer's padded loss (``_build_chunk_fn``'s ``one_loss``) and
    its gradients, jitted once per loss type, with t, the noise and the
    scale passed in."""
    _, jsched = _scheds()
    model = FlaxSinDDMNet(dim=DIM)
    gammas_all = jnp.concatenate([jnp.zeros((1, jsched.num_timesteps), jnp.float32), jsched.gammas], axis=0)

    def make(loss_type):
        @jax.jit
        def step(params, orig_p, blur_p, mask_p, t, noise, s):
            def loss_fn(p):
                x_orig, x_blur, mask = orig_p[s][None], blur_p[s][None], mask_p[s]
                g = jax_extract(gammas_all[s], t)
                x_noisy = jax_q_sample(jsched, g * x_blur + (1.0 - g) * x_orig, t, noise)
                pred = model.apply({"params": p}, x_noisy, t, s.astype(jnp.float32), mask=mask[None])
                err = jnp.abs(noise - pred) if loss_type == "l1" else (noise - pred) ** 2
                w = jnp.broadcast_to(mask[None], err.shape)
                return jnp.sum(err * w) / jnp.sum(w)

            return jax.value_and_grad(loss_fn)(params)

        return step

    return make


def _canvas_draws(seed):
    rng = np.random.default_rng(seed)
    hm, wm = SIZES_HW[-1]
    return rng.integers(0, 100, (BATCH,)), rng.standard_normal((BATCH, hm, wm, 3)).astype(np.float32)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_padded_step_matches_the_jax_formula(tmp_path, jax_padded_step, loss_type, one_torch_thread):  # noqa: F811
    """At s = 0 (the zero gamma row) and s = 1 (a valid region smaller than
    the canvas), from the same flax parameters: the loss and every
    gradient. The canvas stack is the JAX package's ``_stack_padded``."""
    step = jax_padded_step(loss_type)
    tree = random_flax_params(dim=DIM, seed=13)
    canvas = jax_stack_padded(_pyramid())
    for ours_a, theirs_a in zip(_trainer(tmp_path, TrainConfig(train_batch_size=BATCH)).canvas, canvas):
        np.testing.assert_array_equal(ours_a.numpy(), theirs_a)
    for s in (0, 1):
        t, noise = _canvas_draws(30 + s)
        jloss, jgrads = step(jax.tree.map(jnp.asarray, tree), *map(jnp.asarray, canvas), jnp.asarray(t),
                             jnp.asarray(noise), jnp.asarray(s))
        tr = _trainer(tmp_path, TrainConfig(train_batch_size=BATCH), loss_type=loss_type)
        tr.model.load_state_dict(denoiser_params_from_flax(tree))
        loss, scale = tr._step(torch.tensor(s), t=[torch.tensor(t)], noise=[torch.tensor(noise)])
        assert scale.item() == s
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=0)
        theirs = denoiser_params_from_flax(jax.tree.map(np.asarray, jgrads))
        g_max = max(g.abs().max().item() for g in theirs.values())
        g_err = max((p.grad - theirs[k]).abs().max().item() for k, p in tr.model.named_parameters())
        assert g_err <= 1e-5 * g_max, (s, g_err / g_max)


@pytest.mark.parametrize("s", [0, 1, 2])
def test_padded_step_equals_the_true_shape_step(tmp_path, s, one_torch_thread):  # noqa: F811
    """The canvas step's loss and gradients against the step at the
    scale's true shape, on the canvas draws' valid region (s = 2 fills the
    canvas)."""
    h, w = SIZES_HW[s]
    t, noise = (torch.tensor(a) for a in _canvas_draws(40 + s))
    cfg = TrainConfig(train_batch_size=BATCH)
    padded, true_shape = _trainer(tmp_path, cfg), _trainer(tmp_path, cfg)
    loss_p, _ = padded._step(torch.tensor(s), t=[t], noise=[noise])
    loss_t, _ = true_shape._step(s, t=[t], noise=[noise[:, :h, :w].contiguous()])
    np.testing.assert_allclose(loss_p.item(), loss_t.item(), rtol=1e-6, atol=0)
    grads = {k: p.grad for k, p in true_shape.model.named_parameters()}
    g_max = max(g.abs().max().item() for g in grads.values())
    g_err = max((p.grad - grads[k]).abs().max().item() for k, p in padded.model.named_parameters())
    assert g_err <= 1e-6 * g_max, g_err / g_max


@pytest.mark.parametrize("c,co", [(3, 8), (8, 8)])
def test_train_block_mask_mode_equals_the_crop(c, co, one_torch_thread):  # noqa: F811
    """``conv_block_train(mask=)`` on a 2x13x17 canvas with a 9x11 valid
    region: the output there, and the gradients of every weight and of the
    input there (for a loss on the valid region), equal the block's on the
    9x11 crop (1e-6 absolute on outputs of order 1, each gradient within
    1e-6 of its largest value); the input's gradient is 0 outside."""
    rng = np.random.default_rng(5)
    n = lambda *shape, scale=1.0: torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale)  # noqa: E731
    x = n(2, 13, 17, c)
    weights = [n(2, c, scale=0.2), n(5, 5, c, scale=0.2), n(c, scale=0.1), n(3, 3, c, co, scale=(9 * c) ** -0.5),
               n(co, scale=0.1), n(3, 3, co, co, scale=(9 * co) ** -0.5), n(co, scale=0.1),
               n(c, co, scale=c ** -0.5) if c != co else None, n(co, scale=0.1) if c != co else None]
    mask = torch.zeros((1, 13, 17, 1))
    mask[:, :9, :11] = 1.0
    target = n(2, 9, 11, co)

    def run(xx, m):
        xx = xx.clone().requires_grad_(True)
        ws = [None if v is None else v.clone().requires_grad_(True) for v in weights]
        out = conv_block_train(xx, *ws, mask=m)[:, :9, :11]
        (out * target).sum().backward()
        return out.detach(), xx.grad, [None if v is None else v.grad for v in ws]

    out_m, gx_m, gw_m = run(x, mask)
    out_c, gx_c, gw_c = run(x[:, :9, :11].contiguous(), None)
    torch.testing.assert_close(out_m, out_c, atol=1e-6, rtol=0)
    torch.testing.assert_close(gx_m[:, :9, :11], gx_c, atol=1e-6 * gx_c.abs().max().item(), rtol=0)
    assert not gx_m[:, 9:].any() and not gx_m[:, :, 11:].any()
    for a, b in zip(gw_m, gw_c):
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-6 * b.abs().max().item(), rtol=0)


def test_eager_chunk_equals_the_same_steps_one_by_one(tmp_path, one_torch_thread):  # noqa: F811
    """A grouped chunk of 9 steps (3 at each scale) and a padded chunk of 3,
    from step 3: the lr milestone at step 5 and the EMA's warm-up end at
    step 7 fall inside the first. The same steps through ``train_step`` (and
    the canvas step) in a second trainer: parameters, EMA, Adam, lr, the
    step and the scales equal, and so are the losses."""
    cfg = TrainConfig(train_batch_size=BATCH, sched_milestones=(5, 100), step_start_ema=7, update_ema_every=2,
                      ema_decay=0.9)
    chunked, stepped = _trainer(tmp_path, cfg), _trainer(tmp_path, cfg)
    for tr in (chunked, stepped):
        for s in (2, 0, 1):
            tr.train_step(s=s)
    losses = chunked.train_chunk_grouped(9)
    order = stepped._rng.permutation(3)
    one_by_one = [stepped.train_step(s=int(s)) for s in order for _ in range(3)]
    np.testing.assert_array_equal(losses, np.float32(one_by_one))
    assert chunked.running_scale[3:] == [int(s) for s in order for _ in range(3)]
    _assert_equal_states(_state(chunked), _state(stepped))
    assert chunked.opt.param_groups[0]["lr"] == cfg.train_lr * cfg.lr_gamma

    losses = chunked.train_chunk(3)
    one_by_one = []
    for s in chunked.running_scale[-3:]:
        assert s == int(torch.multinomial(stepped._s_probs_device, 1, generator=stepped.generator)[0])
        one_by_one.append(stepped._step(torch.tensor(s))[0].item())
        stepped._after_step()
        stepped.running_scale.append(s)
    np.testing.assert_array_equal(losses, np.float32(one_by_one))
    _assert_equal_states(_state(chunked), _state(stepped))


@pytest.mark.parametrize("fused_mode", ["grouped", "padded"])
def test_l1_pred_img_trains_step_by_step(tmp_path, fused_mode, one_torch_thread):  # noqa: F811
    """The JAX trainer has no padded path for ``l1_pred_img``
    (``_build_chunk_fn`` returns None), so ``train()`` runs it step by step
    in both modes; ``train_chunk`` refuses it."""
    cfg = TrainConfig(train_batch_size=1, train_num_steps=4, steps_per_chunk=4, fused_mode=fused_mode,
                      save_and_sample_every=100)
    tr = _trainer(tmp_path, cfg, loss_type="l1_pred_img")
    tr._step = lambda s, t=None, noise=None: (torch.zeros(()), None)
    chunks = []
    tr.train_chunk_grouped = tr.train_chunk = lambda n: chunks.append(n)
    tr.train(log_fn=lambda _: None)
    assert chunks == [] and tr.step == 4 and len(tr.running_scale) == 4
    with pytest.raises(ValueError, match="padded chunk"):
        MultiscaleTrainer.train_chunk(tr, 2)


@pytest.mark.parametrize("fused_mode", ["grouped", "padded"])
def test_checkpoint_after_a_chunk_resumes_the_same_chunks(tmp_path, fused_mode, one_torch_thread):  # noqa: F811
    """A chunk, a checkpoint, a chunk; a trainer of another seed loads the
    checkpoint and runs the second chunk: the same scales, losses and
    state, bit for bit (the checkpoint holds Adam, the schedule and both
    generators; its learning rates are numbers)."""
    cfg = TrainConfig(train_batch_size=BATCH, sched_milestones=(4, 100), fused_mode=fused_mode)
    first = _trainer(tmp_path, cfg)
    chunk = first.train_chunk_grouped if fused_mode == "grouped" else first.train_chunk
    chunk(6)
    first.save(1)
    losses = chunk(6)
    resumed = _trainer(tmp_path, cfg, seed=9)
    resumed.load(1)
    saved = torch.load(tmp_path / "model-1.pt", weights_only=True)
    assert isinstance(saved["opt"]["param_groups"][0]["lr"], float) and saved["sched"]["last_epoch"] == 6
    again = resumed.train_chunk_grouped(6) if fused_mode == "grouped" else resumed.train_chunk(6)
    np.testing.assert_array_equal(again, losses)
    _assert_equal_states(_state(resumed), _state(first))
