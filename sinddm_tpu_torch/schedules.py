"""Diffusion schedules and derived buffers (port of ``sinddm_tpu/schedules.py``).

Every buffer is derived in float64 numpy, exactly as the JAX package does,
and only then cast to a float32 tensor on the requested device. The
per-scale starting timesteps are ``argmax(sigma_t > loss_factor * loss)``
and the reblur rows are ``clip(sigma_t / (loss_factor * loss), 0, 1)``;
sampling clamps them again to <= 0.55.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

GAMMA_SAMPLING_CLAMP = 0.55

_BUFFERS = (
    "betas",
    "alphas_cumprod",
    "alphas_cumprod_prev",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod",
    "posterior_variance",
    "posterior_log_variance_clipped",
    "posterior_mean_coef1",
    "posterior_mean_coef2",
    "sigma_t",
    "gammas",
)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine beta schedule, float64."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, a_min=0, a_max=0.999)


@dataclasses.dataclass(frozen=True)
class Schedules:
    """All diffusion buffers as float32 tensors on one device, plus the
    pyramid-derived timestep counts as Python ints."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    sigma_t: torch.Tensor
    # [n_scales - 1, T]; row s-1 is the reblur mixing schedule of scale s.
    gammas: torch.Tensor

    num_timesteps: int = 100
    num_timesteps_ideal: Tuple[int, ...] = ()
    num_timesteps_trained: Tuple[int, ...] = ()
    n_scales: int = 1

    def gammas_row(self, s: int) -> torch.Tensor:
        """Training-time gamma row for scale s > 0 (unclamped)."""
        return self.gammas[s - 1]

    def gammas_row_sampling(self, s: int) -> torch.Tensor:
        """Sampling-time gamma row for scale s > 0 (clamped to 0.55)."""
        return torch.clamp(self.gammas[s - 1], 0.0, GAMMA_SAMPLING_CLAMP)

    def zero_gamma_row(self, s: int) -> "Schedules":
        """Return a copy with gammas[s-1] zeroed (the image-to-image entry
        scale runs with no reblur mixing)."""
        gammas = self.gammas.clone()
        gammas[s - 1] = 0.0
        return dataclasses.replace(self, gammas=gammas)


def make_schedules(
    *,
    timesteps: int = 100,
    scale_losses: Optional[Sequence[float]] = None,
    n_scales: int = 1,
    loss_factor: float = 1.0,
    train_full_t: bool = True,
    betas: Optional[np.ndarray] = None,
    device="cuda",
) -> Schedules:
    """Precompute every diffusion buffer (float64 on the host, float32 on
    ``device``). ``scale_losses`` are the pyramid's ``rescale_losses``."""
    if betas is None:
        betas = cosine_beta_schedule(timesteps)
    betas = np.asarray(betas, dtype=np.float64)
    (timesteps,) = betas.shape

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    sigma_t = np.sqrt(1.0 - alphas_cumprod) / np.sqrt(alphas_cumprod)

    num_timesteps_ideal = [int(timesteps)]
    num_timesteps_trained = [int(timesteps)]
    if scale_losses is not None:
        for i in range(n_scales - 1):
            ideal = int(np.argmax(sigma_t > loss_factor * scale_losses[i]))
            num_timesteps_ideal.append(ideal)
            num_timesteps_trained.append(int(timesteps) if train_full_t else ideal)

    if n_scales > 1:
        if scale_losses is None:
            raise ValueError("scale_losses required when n_scales > 1")
        gammas = np.stack(
            [
                np.clip(sigma_t / (loss_factor * scale_losses[i]), 0.0, 1.0)
                for i in range(n_scales - 1)
            ]
        )
    else:
        gammas = np.zeros((0, timesteps))

    host = dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        sigma_t=sigma_t,
        gammas=gammas,
    )
    tensors = {
        name: torch.as_tensor(host[name].astype(np.float32), device=device)
        for name in _BUFFERS
    }
    return Schedules(
        **tensors,
        num_timesteps=int(timesteps),
        num_timesteps_ideal=tuple(num_timesteps_ideal),
        num_timesteps_trained=tuple(num_timesteps_trained),
        n_scales=int(n_scales),
    )
