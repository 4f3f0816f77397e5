"""Multiscale trainer: steps, chunks of steps, EMA, checkpoints, logging (port of ``sinddm_tpu/training/trainer.py``).

The JAX trainer's three paths, under its ``TrainConfig`` flags:

* ``steps_per_chunk <= 1`` (or ``train(fused=False)``): one step a call,
  its scale drawn on the host as the JAX package draws it,
  ``np.random.default_rng(seed + 1).choice(n_scales, p=trained / sum)``,
  and its loss fetched after every step;
* ``fused_mode="grouped"`` (the JAX CLI's default): chunks of
  ``steps_per_chunk`` steps, cut at the next checkpoint, each visiting every
  scale ``n // n_scales`` times in the order of ``_rng.permutation`` (the
  same generator, so both packages visit the same scales in the same order
  with the same counts; PARITY.md's deviation 2), at each scale's true
  shape;
* ``fused_mode="padded"``: every scale padded onto one canvas
  (:func:`_stack_padded`, images top-left, mask 1 on the valid pixels), a
  step's scale drawn on the device (``torch.multinomial`` over the
  scales' probabilities from the device generator), the denoiser in its
  valid-mask mode and the loss a masked mean
  (:func:`~sinddm_tpu_torch.diffusion.core.canvas_training_loss`).
  ``l1_pred_img`` has no padded path, and trains step by step in both
  modes, as in the JAX package.

A chunk keeps its losses (and, padded, its scales) in a device buffer and
fetches them once. On the card, in one process, a chunk's steps are
replays of CUDA graphs, the counterpart of the JAX package's ``lax.scan``:
one graph of a whole step (the ``grad_accumulate`` losses, one backward,
Adam) for each shape, one a scale for ``grouped`` and one of the canvas for
``padded``, kept as long as the trainer. Until every shape of its kind has
run :data:`GRAPH_WARMUP_STEPS` steps, a step runs eagerly on the capture
stream (PyTorch's capture recipe); these are real steps, as are replays, so
a step is the same step either way. Then the kind's graphs are captured,
the largest shape first, and share one memory pool (in the JAX default's
first chunk of 100, every scale warms up; from the second on, every step
is a replay). That is safe in any replay order because no graph output lives in
the pool: the gradients and Adam's state are allocated by the eager steps
before capture (the gradients are zeroed in place, never set to None) and
the loss is copied into a buffer allocated outside it. Adam is
``capturable`` with the learning rate a 0-d device tensor, which
``MultiStepLR`` updates in place; the device generator is registered with
every graph, so consecutive replays draw what eager steps would. The EMA,
the scheduler and the step count stay on the host between replays, which
costs no sync: the host knows every step's number. Capture runs inside the
step's :func:`fp32_convs` scope, so cuDNN's TF32 stays off in the graphs.
A failure to capture or replay raises; the card never runs the eager chunk
in its place (``use_graphs = False`` runs it, as the plain version the
graphs are held against). On the CPU every chunk runs eagerly.

A step, on any path:

* each scale's (orig, blur) pair staged once on the device as
  [1, H, W, 3] and broadcast over the batch in the loss;
* ``grad_accumulate`` losses averaged into one, one backward pass;
* the denoiser's blocks as :func:`~sinddm_tpu_torch.ops.conv_block.conv_block_train`
  (PyTorch's convolutions under autograd, the counterpart of the JAX
  package's XLA convolutions), fp32 with cuDNN's TF32 off for the step; a
  train step launches no hand-written kernel;
* Adam (``optax.adam``'s beta, eps) with ``MultiStepLR``, stepped after
  every optimizer step: update k runs at ``lr0 * gamma^|{m <= k}|``, as
  ``make_lr_schedule`` gives it;
* the EMA of ``_ema_update``, on the step count before it is incremented:
  a hard copy while ``step < step_start_ema``, then a lerp, every
  ``update_ema_every`` steps;
* initial parameters in flax's default distributions (``lecun_normal``
  kernels, zero biases) from a CPU ``torch.Generator`` seeded by ``seed``;
  the steps' timesteps and noise (and the padded chunk's scales) from a
  generator on the device seeded by ``seed + 2``;
* ``model-{milestone}.pt`` checkpoints in the reference's layout
  (:mod:`~sinddm_tpu_torch.models.export_reference`) with Adam's state
  dict under the extra key ``opt`` (the reference's ``sched`` key is the
  ``MultiStepLR`` state dict, as here; learning rates as numbers, so a
  checkpoint of the card loads on the CPU and back), the scale
  generator's state under ``rng`` and the device generator's under
  ``generator``, beside ``model-{milestone}.loss.json``. A resume continues
  the same scale order (the JAX package restarts its draws on a resume),
  and on the same device type the same draws.

Under a mesh (``mesh=``, the JAX trainer's batch over ``data``, image H over
``spatial``) every rank draws the scale, ``t`` and the noise of the whole
batch, as one process does, and takes its batch rows and its image rows
with a halo of the denoiser's receptive radius. Its loss is the sum over
the rows it owns divided by the whole batch's count, so the ranks' losses
add up to the batch's; ``l1_pred_img`` tests the whole batch's ``t[0]``.
After the backward pass the gradients are summed over the world, and Adam
and the EMA step alike on every rank. A world runs its chunks uncaptured
(gloo cannot be captured, and NCCL capture is not checked on one card),
with the all-reduce between the backward pass and Adam. Only the primary
rank writes checkpoints; every rank reads them, after a barrier.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
from sinddm_tpu_torch.diffusion.bucketed import place_on_canvas, valid_mask_2d
from sinddm_tpu_torch.diffusion.core import (
    canvas_batch,
    canvas_draws,
    canvas_training_loss,
    p_losses,
    training_draws,
    training_loss,
)
from sinddm_tpu_torch.models.convert import denoiser_params_from_flax
from sinddm_tpu_torch.models.convert_reference import denoiser_params_from_state_dict, read_checkpoint
from sinddm_tpu_torch.models.denoiser import RECEPTIVE_RADIUS, SinDDMNet
from sinddm_tpu_torch.models.export_reference import reference_payload
from sinddm_tpu_torch.ops.conv_block import conv_block_train
from sinddm_tpu_torch.parallel import distributed
from sinddm_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, halo_slab, shard_params, split_range
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import Schedules
from sinddm_tpu_torch.utils.profiling import span

# jax.nn.initializers.variance_scaling's "truncated_normal": the std of a
# standard normal truncated to [-2, 2], by which the scale is divided so
# that the samples' std comes out at sqrt(scale / fan_in)
TRUNC_STD = 0.87962566103423978
# the loss types with a padded chunk (the JAX trainer's _build_chunk_fn);
# the chunk path needs it, in either fused_mode, as in the JAX train()
PADDED_LOSSES = ("l1", "l2")
# eager steps of a shape before its graph is captured (PyTorch's capture
# recipe warms up on the capture stream; here they are real steps)
GRAPH_WARMUP_STEPS = 2
CANVAS = ("canvas",)  # the padded chunk's shape; a scale's is ("scale", s)
_CAPTURE_STREAMS: dict = {}  # device -> the process's capture stream (_capture_stream)


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


def _stack_padded(pairs, sizes_hw) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each scale's (orig, blur) pair ([1, h, w, 3] each) on one canvas, with
    masks: (orig [S, Hm, Wm, 3], blur [S, Hm, Wm, 3], mask [S, Hm, Wm, 1]),
    images in the top-left corner as the bucketed walk places a scale,
    masks 1 on the valid pixels; the JAX trainer's ``_stack_padded``."""
    hw = (max(h for h, _ in sizes_hw), max(w for _, w in sizes_hw))
    orig, blur = (torch.cat([place_on_canvas(pair[i], hw) for pair in pairs]) for i in (0, 1))
    mask = torch.stack([valid_mask_2d(hw, size, orig.device) for size in sizes_hw])
    return orig, blur, mask[..., None].to(orig.dtype)


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one stream on which every trainer of this process warms up and
    captures on ``device``. cuBLAS keeps a workspace for each stream (and
    thread) for the life of the process, and the caching allocator cannot
    free the segment a workspace was cut from: with a stream of its own,
    each trainer would leave a segment as large as a step's activations
    pinned after it is gone."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _host_numbers(state: dict) -> dict:
    """A state dict's 0-d tensors (a device learning rate) as numbers, in
    its values and in lists of them; other entries as they are."""
    def num(v):
        return v.item() if isinstance(v, torch.Tensor) and v.ndim == 0 else v

    return {k: [num(x) for x in v] if isinstance(v, list) else num(v) for k, v in state.items()}


class _Graph(NamedTuple):
    """A captured step and the buffers, outside its pool, that it writes."""

    graph: "torch.cuda.CUDAGraph"
    loss: torch.Tensor
    scale: Optional[torch.Tensor]


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
    lr = float(trainer.opt.param_groups[0]["lr"])  # a device tensor on the card
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
    """Owns the parameters, their EMA, Adam and its schedule, the executor of
    the chunks (CUDA graphs on the card, one process), and the loop; the
    apps sample from :attr:`ema_model`."""

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
        with span("sinddm.trainer_init", device=str(device)):
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

            with span("sinddm.trainer_init.params"):
                init_flax_params_(model, seed)
                if mesh is not None:
                    shard_params(model, mesh)
            with span("sinddm.trainer_init.ema"):
                self.ema_model = copy.deepcopy(model).eval().requires_grad_(False)
            with span("sinddm.trainer_init.optimizer"):
                # on the card Adam is capturable, its learning rate a device tensor
                # that a graph reads at every replay; the CPU has no capturable Adam
                self._capturable = self.device.type == "cuda"
                self._lr = torch.full((), train_cfg.train_lr, device=self.device) if self._capturable else None
                self.opt = torch.optim.Adam(model.parameters(), lr=self._lr if self._capturable else train_cfg.train_lr,
                                            betas=(0.9, 0.999), eps=1e-8, capturable=self._capturable)
                self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
                    self.opt, milestones=list(train_cfg.sched_milestones), gamma=train_cfg.lr_gamma)
            self.step = 0

            with span("sinddm.trainer_init.data"):
                self.data_list = [
                    tuple(torch.as_tensor(np.asarray(a, np.float32))[None].to(self.device)
                          for a in (pyramid.images[s], pyramid.recon_images[s]))
                    for s in range(pyramid.n_scales)
                ]
                # the padded chunk's stack, its gamma rows (a zero row for s = 0) and t ranges
                self.canvas = _stack_padded(self.data_list, pyramid.sizes_hw)
                gammas = sched.gammas.to(device=self.device, dtype=torch.float32)
                self.gammas_all = torch.cat([torch.zeros((1, sched.num_timesteps), device=self.device), gammas])
                self.trained = torch.tensor(sched.num_timesteps_trained, device=self.device)
                w = np.asarray(sched.num_timesteps_trained, np.float64)
                self._s_probs = w / w.sum()
                self._s_probs_device = torch.tensor(self._s_probs, dtype=torch.float32, device=self.device)
                self._rng = np.random.default_rng(seed + 1)
                self.generator = torch.Generator(device=self.device).manual_seed(seed + 2)
            self.running_loss: List[float] = []
            self.running_scale: List[int] = []

            # the chunks' executor: CUDA graphs in one process on the card, one
            # pool for all of them, on the process's capture stream
            self.use_graphs = self.device.type == "cuda" and mesh is None
            self._graphs: dict = {}
            self.capture_seconds: dict = {}  # a shape's capture, host seconds (synchronize and instantiate included)
            self._warm = collections.Counter()
            with span("sinddm.trainer_init.graphs"):
                self._pool = torch.cuda.graph_pool_handle() if self.use_graphs else None
                self._stream = _capture_stream(self.device) if self.use_graphs else None

    def model_fn(self, x, t, s, mask=None):
        """The training forward: the denoiser with the differentiable block
        (in the valid-mask mode with ``mask``)."""
        return self.model.run(x, t, s, conv_block_train, mask)

    def _loss(self, s, t=None, noise=None) -> torch.Tensor:
        """The loss of one batch at scale ``s``, drawn (or injected) whole: a
        Python int at its true shape, or a 0-d device tensor on the padded
        canvas. Under a mesh, this rank's part of it (module docstring)."""
        kw = dict(batch_size=self.cfg.train_batch_size, generator=self.generator, t=t, noise=noise)
        canvas = isinstance(s, torch.Tensor)
        if self.mesh is None:
            if canvas:
                return canvas_training_loss(self.model_fn, self.sched, self.canvas, self.gammas_all, self.trained,
                                            s, loss_type=self.diff_cfg.loss_type, **kw)
            x_orig, x_blur = self.data_list[s]
            return training_loss(self.model_fn, self.sched, x_orig, x_blur, s=s, loss_type=self.diff_cfg.loss_type,
                                 **kw)
        if canvas:
            x_orig, x_start, mask, gammas_row = canvas_batch(self.canvas, self.gammas_all, s)
            t, noise = canvas_draws(self.trained, s, x_orig.shape[1:], **kw)
        else:
            x_orig, x_blur = self.data_list[s]
            x_start, mask, gammas_row = (x_blur if s > 0 else x_orig), None, None
            t, noise = training_draws(self.sched, x_orig, s=s, **kw)
        b, h = noise.shape[:2]
        b0, b1 = split_range(b, self.mesh.shape[DATA_AXIS], self.mesh.coords[0])
        h0, h1, in0, in1 = halo_slab(h, self.mesh.shape[SPATIAL_AXIS], self.mesh.coords[1], RECEPTIVE_RADIUS)
        valid = torch.zeros((1, in1 - in0, 1, 1), device=noise.device)
        valid[:, h0 - in0 : h1 - in0] = 1.0
        count = noise.numel()
        model_fn = self.model_fn
        if mask is not None:  # the rows this rank owns, on the scale's valid region
            count = (b * noise.shape[-1]) * mask.sum()
            mask = mask[:, in0:in1]
            valid = valid * mask
            model_fn = lambda x, tt, sc: self.model_fn(x, tt, sc, mask)  # noqa: E731
        return p_losses(model_fn, self.sched, x_start[:, in0:in1], t[b0:b1], noise[b0:b1, in0:in1], s=s,
                        x_orig=x_orig[:, in0:in1], loss_type=self.diff_cfg.loss_type, valid_mask=valid,
                        denominator=count, first_t=t[0], gammas_row=gammas_row)

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

    def _step(self, s, t=None, noise=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One step's device work at scale ``s`` (an int, or a 0-d device
        tensor on the canvas): the losses, one backward pass (the gradients
        zeroed in place), the world's all-reduce under a mesh, and Adam.
        ``t`` and ``noise`` inject the draws, a sequence of
        ``grad_accumulate`` tensors each (the whole batch's, under a mesh
        too). Returns the loss and ``s`` as device tensors: no host sync, so
        a graph can capture it."""
        cfg = self.cfg
        with fp32_convs():
            losses = [self._loss(s, None if t is None else t[g], None if noise is None else noise[g])
                      for g in range(cfg.grad_accumulate)]
            loss = torch.stack(losses).mean()
            self.opt.zero_grad(set_to_none=False)
            loss.backward()
        if self.mesh is not None:
            loss = self._sum_over_world(loss)
        self.opt.step()
        return loss.detach(), s if isinstance(s, torch.Tensor) else None

    def _canvas_step(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One padded step: its scale drawn on the device, then :meth:`_step`."""
        return self._step(torch.multinomial(self._s_probs_device, 1, generator=self.generator)[0])

    def _after_step(self) -> None:
        """The host's part of a step: the schedule, the EMA on the step count
        before its increment, the count."""
        self.scheduler.step()
        if self._capturable and self.opt.param_groups[0]["lr"] is not self._lr:
            raise RuntimeError("MultiStepLR replaced the device learning rate that the captured steps read")
        ema_update_(self.ema_model, self.model, self.step, self.cfg)
        self.step += 1

    def train_step(self, s: Optional[int] = None, t=None, noise=None) -> float:
        """One step at scale ``s`` (drawn on the host when None), eager;
        ``t`` and ``noise`` inject the draws as :meth:`_step` takes them.
        Returns the step's loss (a host sync)."""
        if s is None:
            s = int(self._rng.choice(len(self._s_probs), p=self._s_probs))
        loss, _ = self._step(s, t, noise)
        self._after_step()
        self.running_scale.append(s)
        return float(loss)

    # ---- chunks ---------------------------------------------------------
    def train_scale(self, s: int, k: int) -> torch.Tensor:
        """``k`` steps at scale ``s`` (a grouped chunk's sub-chunk); returns
        their losses on the device."""
        losses = torch.empty((k,), device=self.device)
        self._run(("scale", s), k, losses)
        self.running_scale.extend([s] * k)
        return losses

    def train_chunk_grouped(self, n_steps: int) -> np.ndarray:
        """``n_steps`` steps as shuffled per-scale sub-chunks: every scale
        ``n_steps // n_scales`` times (at least once), the last in the order
        taking what is left, as the JAX trainer's ``train_chunk_grouped``.
        Returns the losses, fetched once."""
        n_scales = self.pyramid.n_scales
        per = max(n_steps // n_scales, 1)
        with span("sinddm.train_chunk", n_steps=n_steps, mode="grouped"):
            order = self._rng.permutation(n_scales)
            losses, done = [], 0
            for idx, s in enumerate(order):
                k = min(per if idx < n_scales - 1 else n_steps - done, n_steps - done)
                if k <= 0:
                    break
                losses.append(self.train_scale(int(s), k))
                done += k
            return torch.cat(losses).cpu().numpy() if losses else np.zeros((0,), np.float32)

    def train_chunk(self, n_steps: int) -> np.ndarray:
        """``n_steps`` padded steps, each at a scale drawn on the device;
        the losses and the scales fetched once. Returns the losses."""
        if self.diff_cfg.loss_type not in PADDED_LOSSES:
            raise ValueError(f"the padded chunk takes loss_type {PADDED_LOSSES}, not {self.diff_cfg.loss_type!r}")
        with span("sinddm.train_chunk", n_steps=n_steps, mode="padded"):
            out = torch.empty((2, n_steps), device=self.device)
            self._run(CANVAS, n_steps, out[0], out[1])
            losses, scales = out.cpu().numpy()
        self.running_scale.extend(int(v) for v in scales)
        return losses

    def _run(self, key, k: int, losses: torch.Tensor, scales: Optional[torch.Tensor] = None) -> None:
        """``k`` steps of shape ``key`` (a scale's, or the canvas's), each
        loss (and scale) written into ``losses[i]`` (``scales[i]``) on the
        device, the host's part after each. With :attr:`use_graphs` a step
        is a replay of ``key``'s graph once it is captured (module
        docstring)."""
        for i in range(k):
            kind = self._step_kind(key)
            with span("sinddm.train_step", key=key, kind=kind, ema=self._ema_due()):
                loss, s = self._graph_step(key, kind) if self.use_graphs else self._step_fn(key)()
                losses[i].copy_(loss)
                if scales is not None:
                    scales[i].copy_(s)
                self._after_step()

    def _ema_due(self) -> bool:
        """Whether the next step's :meth:`_after_step` updates the EMA."""
        return self.step % self.cfg.update_ema_every == 0

    def _step_kind(self, key) -> str:
        """How the next step of shape ``key`` runs: "replay" (of its graph),
        "capture" (its kind's graphs captured, then replayed) or "eager"."""
        if not self.use_graphs:
            return "eager"
        if key in self._graphs:
            return "replay"
        return "capture" if all(self._warm[k] >= GRAPH_WARMUP_STEPS for k in self._shapes_of_kind(key)) else "eager"

    def _shapes_of_kind(self, key) -> list:
        """Every shape of ``key``'s kind: the canvas, or every scale."""
        return [CANVAS] if key == CANVAS else [("scale", s) for s in range(self.pyramid.n_scales)]

    def _step_fn(self, key):
        """The device work of one step of shape ``key``."""
        return self._canvas_step if key == CANVAS else (lambda: self._step(key[1]))

    def _pixels(self, key) -> int:
        h, w = self.canvas[0].shape[1:3] if key == CANVAS else self.pyramid.sizes_hw[key[1]]
        return h * w

    def _graph_step(self, key, kind: str):
        """One step of shape ``key`` on the card, as :meth:`_step_kind` gave
        it: a replay of its graph, or, until every shape of its kind (every
        scale, or the canvas) has run :data:`GRAPH_WARMUP_STEPS` eager steps
        on the capture stream, one more. Then the kind's graphs are
        captured, the largest shape first, so that each smaller step fits in
        the blocks the larger captures left free in the shared pool (smallest
        first, the pool grows by most of each step's peak)."""
        if kind == "capture":
            for k in sorted(self._shapes_of_kind(key), key=self._pixels, reverse=True):
                if k not in self._graphs:
                    t0 = time.perf_counter()
                    with span("sinddm.graph_capture", key=k):
                        self._graphs[k] = self._capture(self._step_fn(k))
                    self.capture_seconds[k] = time.perf_counter() - t0
        if kind != "eager":
            entry = self._graphs[key]
            entry.graph.replay()
            return entry.loss, entry.scale
        self._warm[key] += 1
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self._step_fn(key)()
        main.wait_stream(self._stream)
        return out

    def _capture(self, step_fn) -> _Graph:
        """Capture one step of ``step_fn`` into a graph of the shared pool;
        the loss (and scale) go to buffers allocated here, outside it. An
        autograd graph that a caller keeps alive on these parameters, made
        on another stream, makes the capture fail (PyTorch keeps a leaf's
        AccumulateGrad on the stream it was made on)."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        loss_out = torch.zeros((), device=self.device)
        scale_out = torch.zeros((), dtype=torch.long, device=self.device)
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            loss, s = step_fn()
            loss_out.copy_(loss)
            if s is not None:
                scale_out.copy_(s)
        return _Graph(graph, loss_out, scale_out if s is not None else None)

    def train(self, fused: bool = True, on_milestone: Optional[Callable[[int, "MultiscaleTrainer"], None]] = None,
              log_fn: Callable[[str], None] = print) -> None:
        """Train to ``train_num_steps``, checkpointing every
        ``save_and_sample_every`` steps, as the JAX trainer's ``train``: in
        chunks of ``steps_per_chunk`` cut at the next checkpoint when
        ``fused``, ``steps_per_chunk > 1`` and the loss type has a padded
        path (grouped or padded by ``fused_mode``), else step by step. Every
        full window of ``avg_window`` losses is averaged and logged. The rate
        logged counts the steps this call ran (the JAX loop counts the step
        number, which a resumed run would inflate by the steps before it)."""
        cfg = self.cfg
        chunked = fused and cfg.steps_per_chunk > 1 and self.diff_cfg.loss_type in PADDED_LOSSES
        if chunked and self.mesh is not None and self.device.type == "cuda":
            log_fn("a world of ranks runs its training chunks uncaptured (gloo cannot be captured, and NCCL "
                   "capture is not checked on one card)")
        window: List[float] = []
        t0, step0 = time.time(), self.step
        while self.step < cfg.train_num_steps:
            if chunked:
                boundary = min(cfg.train_num_steps,
                               self.step + cfg.save_and_sample_every - self.step % cfg.save_and_sample_every)
                n = min(cfg.steps_per_chunk, boundary - self.step)
                chunk = self.train_chunk_grouped if cfg.fused_mode == "grouped" else self.train_chunk
                window.extend(chunk(n).tolist())
            else:
                window.append(self.train_step())
            while len(window) >= cfg.avg_window:
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
        under ``opt`` and the generators' under ``rng`` / ``generator``),
        ``model-{milestone}.loss.json`` and, where matplotlib imports,
        ``running_loss.png``; under a mesh on the primary rank only, and
        every rank returns after the files are there."""
        path = self.results_folder / f"model-{milestone}.pt"
        if self.mesh is None or distributed.is_primary():
            self._write(milestone, path)
        if self.mesh is not None:
            distributed.barrier()
        return path

    def _write(self, milestone: int, path: Path) -> None:
        payload = reference_payload(self.model, self.ema_model, self.sched, step=self.step,
                                    scheduler_state=_host_numbers(self.scheduler.state_dict()),
                                    running_loss=self.running_loss, running_scale=self.running_scale)
        opt = self.opt.state_dict()
        payload["opt"] = dict(opt, param_groups=[_host_numbers(g) for g in opt["param_groups"]])
        payload["rng"] = self._rng.bit_generator.state
        payload["generator"] = {"device": self.device.type, "state": self.generator.get_state()}
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
        ``model-{milestone}.pt``, and Adam, its schedule and the generators
        where it holds them (one this trainer wrote; the device generator
        only from a checkpoint of the same device type). A reference
        trainer's checkpoint holds none: Adam starts afresh, as after the
        JAX CLI's ``--load_reference_ckpt``. The graphs are captured anew
        (Adam's state tensors are new)."""
        data = read_checkpoint(path)
        load_denoiser_state(self.model, data["model"])
        load_denoiser_state(self.ema_model, data["ema"])
        self.step = int(data.get("step", 0))
        self.running_loss = [float(v) for v in data.get("running_loss", [])]
        self.running_scale = [int(v) for v in data.get("running_scale", [])]
        if "opt" in data:
            self.opt.load_state_dict(data["opt"])
            self.scheduler.load_state_dict(data["sched"])
            self._fit_opt_to_device()
        if "rng" in data:
            self._rng.bit_generator.state = data["rng"]
        gen = data.get("generator")
        if gen is not None and gen["device"] == self.device.type:
            self.generator.set_state(gen["state"])
        self._graphs.clear()
        self._warm.clear()

    def _fit_opt_to_device(self) -> None:
        """Adam's loaded state in this trainer's form: ``capturable`` and the
        learning rate a device tensor (the one the graphs read) on the card,
        a number on the CPU, and each ``step`` where that form keeps it."""
        for group in self.opt.param_groups:
            lr = float(group["lr"])
            group["capturable"] = self._capturable
            if self._capturable:
                self._lr.fill_(lr)
                group["lr"] = self._lr
            else:
                group["lr"] = lr
        for state in self.opt.state.values():
            if "step" in state:
                state["step"] = state["step"].to(self.device if self._capturable else "cpu", torch.float32)
