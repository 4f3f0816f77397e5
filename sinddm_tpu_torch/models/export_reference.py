"""Write the port's denoisers as reference (PyTorch) SinDDM checkpoints.

Port of ``sinddm_tpu/models/export_reference.py``, the inverse of
:mod:`sinddm_tpu_torch.models.convert_reference`, from the port's modules
directly: a :class:`~sinddm_tpu_torch.models.denoiser.SinDDMNet` becomes a
state dict of the reference ``MultiScaleGaussianDiffusion`` (the denoiser's
weights under ``denoise_fn.``, then the schedule buffers), and a
``model-{milestone}.pt`` payload with the reference trainer's keys
``step / model / ema / sched / running_loss / running_scale``, which the
reference trainer, the JAX CLI's ``--load_reference_ckpt`` and the port
read. Layout map (the port's HWIO convs / [out, in] Linears -> torch
OIHW / [out, in]):

  time_mlp{1,2}      -> denoise_fn.time_mlp.{0,2}     (Linear, as is)
  l{i}.cond_mlp      -> denoise_fn.l{i}.mlp.1         (Linear, as is)
  l{i}.cond_proj     -> denoise_fn.l{i}.time_reshape  (Linear -> 1x1 conv)
  l{i}.ds_conv       -> denoise_fn.l{i}.ds_conv       ([5,5,1,C] -> [C,1,5,5])
  l{i}.net_conv{1,2} -> denoise_fn.l{i}.net.{0,2}     ([3,3,I,O] -> [O,I,3,3])
  l{i}.res_conv      -> denoise_fn.l{i}.res_conv      (omitted when identity)
  final_conv         -> denoise_fn.final_conv.0
"""

from __future__ import annotations

from typing import Dict

import torch

from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.schedules import Schedules

# the reference's registered buffers, by their Schedules field names
# (sigma_t is derived but never registered)
BUFFER_FIELDS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "gammas",
)


def state_dict_from_denoiser(model: SinDDMNet, prefix: str = "denoise_fn.") -> Dict[str, torch.Tensor]:
    """The port's denoiser -> reference-named float32 CPU tensors (``prefix
    = ''`` gives a bare ``SinDDMNet`` state dict)."""
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, weight: torch.Tensor, bias: torch.Tensor) -> None:
        out[f"{prefix}{name}.weight"] = weight.detach().float().cpu().contiguous()
        out[f"{prefix}{name}.bias"] = bias.detach().float().cpu().contiguous()

    def conv(name: str, layer) -> None:  # HWIO -> OIHW
        put(name, layer.weight.permute(3, 2, 0, 1), layer.bias)

    put("time_mlp.0", model.time_mlp1.weight, model.time_mlp1.bias)
    put("time_mlp.2", model.time_mlp2.weight, model.time_mlp2.bias)
    for i in (1, 2, 3, 4):
        block = getattr(model, f"l{i}")
        put(f"l{i}.mlp.1", block.cond_mlp.weight, block.cond_mlp.bias)
        put(f"l{i}.time_reshape", block.cond_proj.weight[:, :, None, None], block.cond_proj.bias)
        conv(f"l{i}.ds_conv", block.ds_conv)
        conv(f"l{i}.net.0", block.net_conv1)
        conv(f"l{i}.net.2", block.net_conv2)
        if block.res_conv is not None:
            conv(f"l{i}.res_conv", block.res_conv)
    conv("final_conv.0", model.final_conv)
    return out


def diffusion_state_dict(model: SinDDMNet, sched: Schedules) -> Dict[str, torch.Tensor]:
    """The reference ``MultiScaleGaussianDiffusion`` state dict: the
    denoiser, then the schedule buffers."""
    sd = state_dict_from_denoiser(model)
    for field in BUFFER_FIELDS:
        sd[field] = getattr(sched, field).detach().float().cpu().contiguous()
    return sd


def reference_payload(model: SinDDMNet, ema_model: SinDDMNet, sched: Schedules, *, step: int,
                      scheduler_state: dict, running_loss=(), running_scale=()) -> dict:
    """A ``model-{milestone}.pt`` payload with the reference trainer's keys;
    ``scheduler_state`` is a ``MultiStepLR`` state dict (the reference's
    ``sched``). Callers may add keys of their own: the reference's loader
    reads only these."""
    return {
        "step": int(step),
        "model": diffusion_state_dict(model, sched),
        "ema": diffusion_state_dict(ema_model, sched),
        "sched": scheduler_state,
        "running_loss": [float(v) for v in running_loss],
        "running_scale": [int(v) for v in running_scale],
    }
