"""Multiscale trainer: steps, EMA, checkpoints, logging (port of ``sinddm_tpu/training/trainer.py``).

The JAX trainer's per-step path, one step a call (its fused chunks exist to
run many steps in one XLA call, and the port does not fuse steps):

* each scale's (orig, blur) pair staged once on the device as
  [1, H, W, 3] and broadcast over the batch in the loss;
* the scale of a step drawn on the host as the JAX package draws it,
  ``np.random.default_rng(seed + 1).choice(n_scales, p=trained / sum)``,
  so both packages visit the same scales;
* ``grad_accumulate`` losses averaged into one, one backward pass;
* the denoiser's blocks as :func:`~sinddm_tpu_torch.ops.conv_block.conv_block_train`
  (PyTorch's convolutions under autograd, the counterpart of the JAX
  package's XLA convolutions), fp32 with cuDNN's TF32 off for the step;
* Adam (``optax.adam``'s beta, eps) with ``MultiStepLR``, stepped after
  every optimizer step: update k runs at ``lr0 * gamma^|{m <= k}|``, as
  ``make_lr_schedule`` gives it;
* the EMA of ``_ema_update``, on the step count before it is incremented:
  a hard copy while ``step < step_start_ema``, then a lerp, every
  ``update_ema_every`` steps;
* initial parameters in flax's default distributions (``lecun_normal``
  kernels, zero biases) from a CPU ``torch.Generator`` seeded by ``seed``;
  the steps' timesteps and noise from a generator on the device seeded by
  ``seed + 2``;
* ``model-{milestone}.pt`` checkpoints in the reference's layout
  (:mod:`~sinddm_tpu_torch.models.export_reference`) with Adam's state
  dict under the extra key ``opt`` (the reference's ``sched`` key is the
  ``MultiStepLR`` state dict, as here), beside ``model-{milestone}.loss.json``.

Under a mesh (``mesh=``, the JAX trainer's batch over ``data``, image H over
``spatial``) every rank draws the scale, ``t`` and the noise of the whole
batch, as one process does, and takes its batch rows and its image rows
with a halo of the denoiser's receptive radius. Its loss is the sum over
the rows it owns divided by the whole batch's count, so the ranks' losses
add up to the batch's; ``l1_pred_img`` tests the whole batch's ``t[0]``.
After the backward pass the gradients are summed over the world, and Adam
and the EMA step alike on every rank. Only the primary rank writes
checkpoints; every rank reads them, after a barrier.
"""

from __future__ import annotations

import copy
import json
import math
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
from sinddm_tpu_torch.diffusion.core import p_losses, training_draws, training_loss
from sinddm_tpu_torch.models.convert import denoiser_params_from_flax
from sinddm_tpu_torch.models.convert_reference import denoiser_params_from_state_dict, read_checkpoint
from sinddm_tpu_torch.models.denoiser import RECEPTIVE_RADIUS, SinDDMNet
from sinddm_tpu_torch.models.export_reference import reference_payload
from sinddm_tpu_torch.ops.conv_block import conv_block_train
from sinddm_tpu_torch.parallel import distributed
from sinddm_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, halo_slab, shard_params, split_range
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import Schedules

# jax.nn.initializers.variance_scaling's "truncated_normal": the std of a
# standard normal truncated to [-2, 2], by which the scale is divided so
# that the samples' std comes out at sqrt(scale / fan_in)
TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init in place: a normal truncated at two of its
    std, scaled to std sqrt(1 / fan_in) after the truncation. Drawn on the
    CPU, so a seed gives the same values on any device."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    w = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    with torch.no_grad():
        weight.copy_(w)


def init_flax_params_(model: SinDDMNet, seed: int) -> None:
    """Every parameter of ``model`` in flax's default distributions: kernels
    ``lecun_normal`` (a conv's fan_in kh * kw * Cin, the depthwise conv's
    25; a Dense layer's its input width), biases zero."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            with torch.no_grad():
                p.zero_()
        elif p.ndim == 4:  # a conv, HWIO
            lecun_normal_(p, p.shape[0] * p.shape[1] * p.shape[2], gen)
        else:  # nn.Linear, [out, in]
            lecun_normal_(p, p.shape[1], gen)


@torch.no_grad()
def ema_update_(ema: nn.Module, model: nn.Module, step: int, cfg: TrainConfig) -> None:
    """The JAX package's ``_ema_update`` in place, at ``step`` (the count
    before this step's increment): on every ``update_ema_every``-th step a
    hard copy while ``step < step_start_ema``, else ``e * decay + (1 -
    decay) * p``."""
    if step % cfg.update_ema_every != 0:
        return
    b = cfg.ema_decay
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(p if step < cfg.step_start_ema else e * b + (1.0 - b) * p)


def fp32_convs():
    """cuDNN's convolutions in true fp32 (TF32 off) for a scope; the other
    cuDNN switches stay as they are."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=False)


def step_vs_float64(trainer: "MultiscaleTrainer", s: int, t, noise) -> dict:
    """One :meth:`MultiscaleTrainer.train_step` at scale ``s`` with the
    injected draws ``t`` and ``noise`` (``grad_accumulate`` tensors each)
    against the same step in float64 (:func:`conv_block_train` and Adam in
    float64) from the same parameters; the oracle of the card's checks.

    Returns ``loss_rel`` (the loss's relative error), ``grad_rel`` (the
    largest gradient error over the largest gradient), ``change_max_lr``
    (the largest error of a parameter's change, in units of lr) and
    ``change_share`` (the share of elements whose change is off by more
    than 1e-2 lr: Adam's first step is about lr times the gradient's sign,
    which a gradient near zero may flip)."""
    model64 = copy.deepcopy(trainer.model).double()
    model64.compute_dtype = torch.float64  # an oracle only: no kernel takes float64
    start = [p.detach().clone() for p in trainer.model.parameters()]
    lr = trainer.opt.param_groups[0]["lr"]
    opt64 = torch.optim.Adam(model64.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    x_orig, x_blur = trainer.data_list[s]
    loss32 = trainer.train_step(s=s, t=t, noise=noise)
    fn64 = lambda x, tt, sc: model64.run(x, tt, sc, conv_block_train)  # noqa: E731
    loss64 = torch.stack([
        training_loss(fn64, trainer.sched, x_orig.double(), x_blur.double(), s=s, batch_size=len(tg),
                      loss_type=trainer.diff_cfg.loss_type, t=tg, noise=ng.double())
        for tg, ng in zip(t, noise)
    ]).mean()
    loss64.backward()
    opt64.step()
    pairs = list(zip(trainer.model.parameters(), model64.parameters(), start))
    g_max = max(p64.grad.abs().max().item() for _, p64, _ in pairs)
    g_err = max((p.grad.double() - p64.grad).abs().max().item() for p, p64, _ in pairs)
    change = torch.cat([((p.double() - p0.double()) - (p64 - p0.double())).abs().flatten()
                        for p, p64, p0 in pairs]) / lr
    return {"loss_rel": abs(loss32 - loss64.item()) / abs(loss64.item()), "grad_rel": g_err / g_max,
            "change_max_lr": change.max().item(), "change_share": (change > 1e-2).double().mean().item()}


def latest_milestone(folder) -> Optional[int]:
    """The highest milestone with a ``model-{milestone}.pt`` in ``folder``, or None."""
    found = [int(p.stem.split("-")[1]) for p in Path(folder).glob("model-*.pt") if p.stem.split("-")[1].isdigit()]
    return max(found) if found else None


def checkpoint_path(folder, milestone: int) -> Path:
    """``folder/model-{milestone}.pt``; -1 is the latest milestone there."""
    if milestone == -1:
        latest = latest_milestone(folder)
        if latest is None:
            raise FileNotFoundError(f"no model-*.pt checkpoints under {folder}")
        milestone = latest
    return Path(folder) / f"model-{milestone}.pt"


def load_denoiser_state(model: SinDDMNet, state_dict) -> None:
    """Load a reference-layout state dict (``model`` or ``ema`` of a
    ``model-{milestone}.pt``) into ``model``, strictly."""
    params = denoiser_params_from_flax(denoiser_params_from_state_dict(state_dict))
    model.load_state_dict(params, strict=True)


class MultiscaleTrainer:
    """Owns the parameters, their EMA, Adam and its schedule, and the loop;
    the apps sample from :attr:`ema_model`."""

    def __init__(
        self,
        model: SinDDMNet,
        sched: Schedules,
        pyramid: Pyramid,
        train_cfg: TrainConfig,
        diff_cfg: DiffusionConfig,
        results_folder,
        seed: int = 0,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.device = torch.device(device)
        self.mesh = mesh
        if model.compute_dtype != torch.float32:
            raise ValueError(f"the trainer trains in float32, got a {model.compute_dtype} model")
        wrong = {str(p.device) for p in model.parameters() if p.device.type != self.device.type}
        if wrong:
            raise ValueError(f"the trainer runs on {self.device}, but the model's parameters lie on {wrong}")
        self.model = model.train()
        self.sched = sched
        self.pyramid = pyramid
        self.cfg = train_cfg
        self.diff_cfg = diff_cfg
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)

        init_flax_params_(model, seed)
        if mesh is not None:
            shard_params(model, mesh)
        self.ema_model = copy.deepcopy(model).eval().requires_grad_(False)
        self.opt = torch.optim.Adam(model.parameters(), lr=train_cfg.train_lr, betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.opt, milestones=list(train_cfg.sched_milestones), gamma=train_cfg.lr_gamma)
        self.step = 0

        self.data_list = [
            tuple(torch.as_tensor(np.asarray(a, np.float32))[None].to(self.device)
                  for a in (pyramid.images[s], pyramid.recon_images[s]))
            for s in range(pyramid.n_scales)
        ]
        w = np.asarray(sched.num_timesteps_trained, np.float64)
        self._s_probs = w / w.sum()
        self._rng = np.random.default_rng(seed + 1)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 2)
        self.running_loss: List[float] = []
        self.running_scale: List[int] = []

    def model_fn(self, x, t, s):
        """The training forward: the denoiser with the differentiable block."""
        return self.model.run(x, t, s, conv_block_train)

    def _loss(self, s: int, t, noise) -> torch.Tensor:
        """The loss of one batch, drawn (or injected) whole; under a mesh,
        this rank's part of it (module docstring)."""
        x_orig, x_blur = self.data_list[s]
        kw = dict(s=s, batch_size=self.cfg.train_batch_size, generator=self.generator, t=t, noise=noise)
        if self.mesh is None:
            return training_loss(self.model_fn, self.sched, x_orig, x_blur, loss_type=self.diff_cfg.loss_type, **kw)
        t, noise = training_draws(self.sched, x_orig, **kw)
        b, h = noise.shape[:2]
        b0, b1 = split_range(b, self.mesh.shape[DATA_AXIS], self.mesh.coords[0])
        h0, h1, in0, in1 = halo_slab(h, self.mesh.shape[SPATIAL_AXIS], self.mesh.coords[1], RECEPTIVE_RADIUS)
        owned = torch.zeros((1, in1 - in0, 1, 1), device=noise.device)
        owned[:, h0 - in0 : h1 - in0] = 1.0
        x_start = x_blur if s > 0 else x_orig
        return p_losses(self.model_fn, self.sched, x_start[:, in0:in1], t[b0:b1], noise[b0:b1, in0:in1], s=s,
                        x_orig=x_orig[:, in0:in1] if s > 0 else None, loss_type=self.diff_cfg.loss_type,
                        valid_mask=owned, denominator=noise.numel(), first_t=t[0])

    def _sum_over_world(self, loss: torch.Tensor) -> torch.Tensor:
        """Sum the parameters' gradients and the loss over the world (one
        all-reduce); every rank then holds the whole batch's."""
        params = list(self.model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params]
                         + [loss.detach().reshape(1)])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            p.grad = flat[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        return flat[offset]

    def train_step(self, s: Optional[int] = None, t=None, noise=None) -> float:
        """One step at scale ``s`` (drawn when None); ``t`` and ``noise``
        inject the draws, a sequence of ``grad_accumulate`` tensors each
        (the whole batch's, under a mesh too). Returns the step's loss."""
        cfg = self.cfg
        if s is None:
            s = int(self._rng.choice(len(self._s_probs), p=self._s_probs))
        with fp32_convs():
            losses = [self._loss(s, None if t is None else t[g], None if noise is None else noise[g])
                      for g in range(cfg.grad_accumulate)]
            loss = torch.stack(losses).mean()
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        if self.mesh is not None:
            loss = self._sum_over_world(loss)
        self.opt.step()
        self.scheduler.step()
        ema_update_(self.ema_model, self.model, self.step, cfg)
        self.step += 1
        self.running_scale.append(s)
        return float(loss.detach())

    def train(self, on_milestone: Optional[Callable[[int, "MultiscaleTrainer"], None]] = None,
              log_fn: Callable[[str], None] = print) -> None:
        """Train to ``train_num_steps``, averaging the loss over windows of
        ``avg_window`` steps, and checkpoint every ``save_and_sample_every``."""
        cfg = self.cfg
        window: List[float] = []
        t0, step0 = time.time(), self.step
        while self.step < cfg.train_num_steps:
            window.append(self.train_step())
            if len(window) >= cfg.avg_window:
                avg = float(np.mean(window[: cfg.avg_window]))
                window = window[cfg.avg_window :]
                self.running_loss.append(avg)
                sps = (self.step - step0) / max(time.time() - t0, 1e-9)
                log_fn(f"step:{self.step} loss:{avg:.5f} ({sps:.1f} steps/s)")
            if self.step % cfg.save_and_sample_every == 0:
                milestone = self.step // cfg.save_and_sample_every
                self.save(milestone)
                if on_milestone is not None:
                    on_milestone(milestone, self)
        log_fn("training completed")

    # ---- checkpoints ----------------------------------------------------
    def save(self, milestone: int) -> Path:
        """Write ``model-{milestone}.pt`` (reference layout, plus Adam's state
        under ``opt``), ``model-{milestone}.loss.json`` and, where matplotlib
        imports, ``running_loss.png``; under a mesh on the primary rank only,
        and every rank returns after the files are there."""
        path = self.results_folder / f"model-{milestone}.pt"
        if self.mesh is None or distributed.is_primary():
            self._write(milestone, path)
        if self.mesh is not None:
            distributed.barrier()
        return path

    def _write(self, milestone: int, path: Path) -> None:
        payload = reference_payload(self.model, self.ema_model, self.sched, step=self.step,
                                    scheduler_state=self.scheduler.state_dict(), running_loss=self.running_loss,
                                    running_scale=self.running_scale)
        payload["opt"] = self.opt.state_dict()
        torch.save(payload, path)
        (self.results_folder / f"model-{milestone}.loss.json").write_text(
            json.dumps({"running_loss": self.running_loss}))
        try:  # the running-loss curve, as the reference draws it; skipped without matplotlib
            import matplotlib

            matplotlib.use("Agg")
            from matplotlib import pyplot as plt
        except ImportError:
            return
        plt.figure(figsize=(16, 8))
        plt.plot(self.running_loss)
        plt.grid(True)
        plt.ylim((0, 0.2))
        plt.savefig(str(self.results_folder / "running_loss.png"))
        plt.close()

    def latest_milestone(self) -> Optional[int]:
        return latest_milestone(self.results_folder)

    def load(self, milestone: int) -> None:
        """Restore ``model-{milestone}.pt`` of the results folder; -1 resumes
        from the latest one."""
        self.load_path(checkpoint_path(self.results_folder, milestone))

    def load_path(self, path) -> None:
        """Restore the weights, the EMA, the step and the running loss of a
        ``model-{milestone}.pt``, and Adam and its schedule where it holds
        Adam's state (one this trainer wrote). A reference trainer's
        checkpoint holds none, and Adam starts afresh, as after the JAX
        CLI's ``--load_reference_ckpt``."""
        data = read_checkpoint(path)
        load_denoiser_state(self.model, data["model"])
        load_denoiser_state(self.ema_model, data["ema"])
        self.step = int(data.get("step", 0))
        self.running_loss = [float(v) for v in data.get("running_loss", [])]
        self.running_scale = [int(v) for v in data.get("running_scale", [])]
        if "opt" in data:
            self.opt.load_state_dict(data["opt"])
            self.scheduler.load_state_dict(data["sched"])
