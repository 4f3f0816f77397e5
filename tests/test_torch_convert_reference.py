"""Reference-layout ``model-{milestone}.pt`` checkpoints, both ways between
the packages: the JAX package's writer to the port's reader, and the port's
writer (and its trainer's checkpoints) to the JAX package's reader. The
checkpoints are written here under ``tmp_path`` from seeded random
parameters; tensors must agree exactly (both sides only move and transpose
float32 values)."""

import jax
import numpy as np
import pytest
import torch

from sinddm_tpu.models.convert_reference import load_reference_checkpoint as jax_load
from sinddm_tpu.models.export_reference import save_reference_checkpoint as jax_save
from sinddm_tpu.schedules import make_schedules as jax_make_schedules
from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
from sinddm_tpu_torch.models.convert import denoiser_from_flax, denoiser_params_from_flax, random_flax_params
from sinddm_tpu_torch.models.convert_reference import denoiser_params_from_state_dict, load_reference_checkpoint
from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.models.export_reference import (
    BUFFER_FIELDS,
    reference_payload,
    state_dict_from_denoiser,
)
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import make_schedules
from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

LOSSES = (0.31, 0.22)


def _assert_trees_equal(a, b):
    flat_a = denoiser_params_from_flax(jax.tree.map(np.asarray, a))
    flat_b = denoiser_params_from_flax(jax.tree.map(np.asarray, b))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        torch.testing.assert_close(flat_a[k], flat_b[k], atol=0, rtol=0)


@pytest.mark.parametrize("dim", [8, 16])
def test_port_reads_what_the_jax_package_writes(tmp_path, dim):
    """save_reference_checkpoint of random params and EMA -> the port's
    loader gives the tensors denoiser_from_flax gives from the same trees,
    and the step."""
    params, ema = random_flax_params(dim=dim, seed=1), random_flax_params(dim=dim, seed=2)
    path = tmp_path / "model-3.pt"
    jax_save(str(path), params, ema, jax_make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3), step=30000)
    p, e, step = load_reference_checkpoint(path)
    assert step == 30000
    for ours, tree in ((p, params), (e, ema)):
        got = denoiser_from_flax(ours, device="cpu").state_dict()
        want = denoiser_from_flax(tree, device="cpu").state_dict()
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


@pytest.mark.parametrize("dim", [8, 16])
def test_jax_package_reads_what_the_port_writes(tmp_path, dim):
    """The port's writer -> the JAX package's load_reference_checkpoint
    gives back the trees the port's modules were loaded from; the payload
    carries the reference trainer's keys and the schedule buffers."""
    params, ema = random_flax_params(dim=dim, seed=3), random_flax_params(dim=dim, seed=4)
    model, ema_model = (denoiser_from_flax(t, device="cpu") for t in (params, ema))
    sched = make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3, device="cpu")
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=1e-3)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(opt, milestones=[20000], gamma=0.5)
    payload = reference_payload(model, ema_model, sched, step=12, scheduler_state=scheduler.state_dict(),
                                running_loss=[0.5, 0.25])
    assert set(payload) == {"step", "model", "ema", "sched", "running_loss", "running_scale"}
    jsched = jax_make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3)
    for field in BUFFER_FIELDS:
        np.testing.assert_array_equal(payload["model"][field].numpy(), np.asarray(getattr(jsched, field)))
    path = tmp_path / "model-1.pt"
    torch.save(payload, path)
    p, e, step = jax_load(str(path))
    assert step == 12
    _assert_trees_equal(p, params)
    _assert_trees_equal(e, ema)
    bare = state_dict_from_denoiser(model, prefix="")
    _assert_trees_equal(denoiser_params_from_state_dict(bare), params)


def test_trainer_checkpoints_are_reference_checkpoints(tmp_path):
    """A checkpoint of the port's trainer is read by the JAX package as the
    trainer's weights and EMA, with Adam's state kept under ``opt``."""
    rng = np.random.default_rng(0)
    sizes = ((12, 16), (17, 23), (24, 32))
    images = tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in sizes)
    pyr = Pyramid(sizes_hw=sizes, sizes_wh=tuple((w, h) for h, w in sizes), images=images, recon_images=images,
                  rescale_losses=LOSSES, scale_factor=1.41, n_scales=3)
    sched = make_schedules(timesteps=100, scale_losses=LOSSES, n_scales=3, device="cpu")
    tr = MultiscaleTrainer(SinDDMNet(dim=8, device="cpu"), sched, pyr, TrainConfig(train_batch_size=1),
                           DiffusionConfig(), tmp_path, seed=0, device="cpu")
    tr.train_step(s=2)
    data = torch.load(tr.save(1), weights_only=True)
    assert data["step"] == 1 and data["running_scale"] == [2] and len(data["opt"]["state"]) > 0
    assert data["sched"]["last_epoch"] == 1
    p, e, step = jax_load(str(tmp_path / "model-1.pt"))
    assert step == 1
    for tree, module in ((p, tr.model), (e, tr.ema_model)):
        flat = denoiser_params_from_flax(jax.tree.map(np.asarray, tree))
        for k, v in module.state_dict().items():
            torch.testing.assert_close(flat[k], v, atol=0, rtol=0)
