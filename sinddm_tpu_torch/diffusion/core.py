"""Multi-scale Gaussian diffusion, sampling side (port of ``sinddm_tpu/diffusion/core.py``).

Pure functions over a :class:`~sinddm_tpu_torch.schedules.Schedules`, a
``model_fn(x, t_vec, s) -> eps`` and a source of noise. The JAX package's
reverse ``lax.scan`` is a Python loop here. Noise comes from an explicit
``torch.Generator`` or from an injected ``noise_fn(shape) -> Tensor``; the
draws happen in the JAX package's order (the initial draw of a scale,
then one per reverse step, t = 0 included), so a test can feed both the
same numbers and compare them step for step.

Shapes are NHWC. ``s`` (the scale index) and the step's ``t`` are Python
ints. A guidance hook ``guidance_fn(x_recon, x_t, t, s, carry) -> (x_recon,
carry, aux)`` edits the predicted clean image of each step (CLIP guidance);
its carry is threaded through the loop and its aux collected per step. The
hook draws its own random numbers (the JAX package hands it a key). The
training losses arrive with their slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sinddm_tpu_torch.schedules import Schedules

# model_fn(x [B,H,W,C], t [B], s [B]) -> eps [B,H,W,C]
ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# noise_fn(shape) -> standard normal float32 tensor of that shape
NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]
# guidance_fn(x_recon, x_t, t, s, carry) -> (x_recon, carry, {name: tensor})
GuidanceFn = Callable[[torch.Tensor, torch.Tensor, int, int, Any], Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]]


def make_noise_fn(generator: Optional[torch.Generator], device) -> NoiseFn:
    """Standard normal draws on ``device`` from ``generator`` (or torch's
    default generator of that device when None)."""
    return lambda shape: torch.randn(shape, generator=generator, device=device)


def extract(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gather schedule coefficients by per-sample timestep -> [B, 1, 1, 1].
    Out-of-range indices clamp to the last entry, as JAX's gather does."""
    return a[t.clamp(max=a.shape[0] - 1)][:, None, None, None]


def q_sample(sched: Schedules, x_start: torch.Tensor, t, noise: torch.Tensor) -> torch.Tensor:
    """Forward noising q(x_t | x_0)."""
    if not isinstance(t, torch.Tensor):  # a fill, not a host-to-device copy (which syncs)
        t = torch.full((x_start.shape[0],), int(t), dtype=torch.long, device=x_start.device)
    elif t.ndim == 0:
        t = t.expand(x_start.shape[0])
    return (
        extract(sched.sqrt_alphas_cumprod, t) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t) * noise
    )


def predict_start_from_noise(
    sched: Schedules,
    x_t: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *,
    s: int,
    reblurring: bool,
    img_prev: Optional[torch.Tensor] = None,
    gammas_row: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predict (x_tm1_mix, x_t_mix) from predicted noise. At s > 0 with
    reblurring the first output solves for the deblurred image
    ``(x0 - gamma_t * img_prev) / (1 - gamma_t)``."""
    x_recon_ddpm = (
        extract(sched.sqrt_recip_alphas_cumprod, t) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t) * noise
    )
    if not reblurring or s == 0:
        return x_recon_ddpm, x_recon_ddpm
    g = extract(gammas_row, t)
    x_tm1_mix = (x_recon_ddpm - g * img_prev) / (1.0 - g)
    return x_tm1_mix, x_recon_ddpm


def q_posterior(
    sched: Schedules,
    x_start: torch.Tensor,
    x_t_mix: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    *,
    s: int,
    reblurring: bool,
    omega: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and log-variance.

    s = 0 or no reblurring: the DDPM posterior. s > 0 with reblurring and
    t > 0: mean = sqrt(abar_{t-1}) x_tm1_mix + sqrt(1 - abar_{t-1} - var)
    (x_t - sqrt(abar_t) x_t_mix) / sqrt(1 - abar_t), var = omega (1 - abar_{t-1}),
    log-variance log(max(var, 1e-20)) -- so omega = 0 still adds
    1e-10 * noise, as the JAX package does. At t = 0 the mean is x_start.
    """
    if not reblurring or s == 0:
        mean = (
            extract(sched.posterior_mean_coef1, t) * x_start
            + extract(sched.posterior_mean_coef2, t) * x_t
        )
        return mean, extract(sched.posterior_log_variance_clipped, t)

    tm1 = torch.clamp(t - 1, min=0)
    var_t = omega * (1.0 - extract(sched.alphas_cumprod, tm1))
    logvar_pos = torch.log(torch.clamp(var_t, min=1e-20))
    mean_pos = extract(sched.sqrt_alphas_cumprod, tm1) * x_start + torch.sqrt(
        1.0 - extract(sched.alphas_cumprod, tm1) - var_t
    ) * (x_t - extract(sched.sqrt_alphas_cumprod, t) * x_t_mix) / extract(
        sched.sqrt_one_minus_alphas_cumprod, t
    )
    is_pos = (t > 0).to(x_t.dtype)[:, None, None, None]
    mean = is_pos * mean_pos + (1.0 - is_pos) * x_start
    logvar0 = extract(sched.posterior_log_variance_clipped, t)
    logvar = is_pos * logvar_pos + (1.0 - is_pos) * logvar0
    return mean, logvar


def p_sample_step(
    model_fn: ModelFn,
    sched: Schedules,
    x: torch.Tensor,
    t: int,
    noise_fn: NoiseFn,
    *,
    s: int,
    reblurring: bool,
    img_prev: Optional[torch.Tensor] = None,
    omega: float = 0.0,
    clip_denoised: bool = True,
    guidance_fn: Optional[GuidanceFn] = None,
    guidance_carry: Any = None,
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """One reverse step x_t -> x_{t-1}; draws one noise tensor. Returns
    (x_next, guidance_carry, guidance_aux)."""
    b = x.shape[0]
    # t and s as device fills: a host-to-device copy would sync every step
    t_vec = torch.full((b,), int(t), dtype=torch.long, device=x.device)
    s_vec = torch.full((b,), float(s), dtype=torch.float32, device=x.device)
    eps = model_fn(x, t_vec, s_vec)

    gammas_row = sched.gammas_row_sampling(s) if (reblurring and s > 0) else None
    x_recon, x_t_mix = predict_start_from_noise(
        sched, x, t_vec, eps, s=s, reblurring=reblurring,
        img_prev=img_prev, gammas_row=gammas_row,
    )
    aux: Dict[str, torch.Tensor] = {}
    if guidance_fn is not None:
        x_recon, guidance_carry, aux = guidance_fn(x_recon, x, int(t), s, guidance_carry)
    if reblurring and s > 0:
        # re-mix with gamma_{t-1} when t > 0
        g_prev = extract(gammas_row, torch.clamp(t_vec - 1, min=0))
        is_pos = (t_vec > 0).to(x.dtype)[:, None, None, None]
        x_tm1_mix = is_pos * (g_prev * img_prev + (1.0 - g_prev) * x_recon) + (
            1.0 - is_pos
        ) * x_recon
    else:
        x_tm1_mix = x_recon

    if clip_denoised:
        x_tm1_mix = torch.clamp(x_tm1_mix, -1.0, 1.0)
        x_t_mix = torch.clamp(x_t_mix, -1.0, 1.0)

    mean, logvar = q_posterior(
        sched, x_tm1_mix, x_t_mix, x, t_vec, s=s, reblurring=reblurring, omega=omega
    )
    noise = noise_fn(tuple(x.shape)).to(device=x.device, dtype=x.dtype)
    nonzero = (t_vec > 0).to(x.dtype)[:, None, None, None]
    return mean + nonzero * torch.exp(0.5 * logvar) * noise, guidance_carry, aux


def _reverse_loop(
    model_fn: ModelFn,
    sched: Schedules,
    x: torch.Tensor,
    noise_fn: NoiseFn,
    t_start: int,
    t_min: int,
    *,
    s: int,
    reblurring: bool,
    img_prev: Optional[torch.Tensor],
    omega: float,
    guidance_fn: Optional[GuidanceFn] = None,
    guidance_carry: Any = None,
    collect_interm: bool = False,
) -> Tuple[torch.Tensor, Any, Optional[Dict[str, torch.Tensor]]]:
    """Run the reverse chain t = t_start-1 .. t_min. Returns (x,
    guidance_carry, aux): aux stacks each step's guidance aux ([n_steps, ...],
    t descending) and, with ``collect_interm``, every state under
    ``"interm"``; it is None when there is neither (or no step)."""
    rows: Dict[str, list] = {}
    for t in range(t_start - 1, t_min - 1, -1):
        x, guidance_carry, step_aux = p_sample_step(
            model_fn, sched, x, t, noise_fn,
            s=s, reblurring=reblurring, img_prev=img_prev, omega=omega,
            guidance_fn=guidance_fn, guidance_carry=guidance_carry,
        )
        if collect_interm:
            step_aux = dict(step_aux, interm=x)
        for name, value in step_aux.items():
            rows.setdefault(name, []).append(value)
    aux = {name: torch.stack(values) for name, values in rows.items()} or None
    return x, guidance_carry, aux


def sample_scale0(
    model_fn: ModelFn,
    sched: Schedules,
    shape: Tuple[int, ...],
    *,
    s: int = 0,
    t_min: int = 0,
    omega: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    device="cuda",
    guidance_fn: Optional[GuidanceFn] = None,
    guidance_carry: Any = None,
    collect_interm: bool = False,
) -> Tuple[torch.Tensor, Any, Optional[Dict[str, torch.Tensor]]]:
    """Sample from pure noise at the coarsest scale; ``shape`` is (B, H, W, C).
    The chain runs T-1 .. t_min. Returns (x, guidance_carry, aux)."""
    if noise_fn is None:
        noise_fn = make_noise_fn(generator, device)
    x = noise_fn(tuple(shape)).to(device=device, dtype=torch.float32)
    return _reverse_loop(
        model_fn, sched, x, noise_fn, sched.num_timesteps, t_min,
        s=s, reblurring=False, img_prev=None, omega=omega,
        guidance_fn=guidance_fn, guidance_carry=guidance_carry,
        collect_interm=collect_interm,
    )


def sample_via_scale(
    model_fn: ModelFn,
    sched: Schedules,
    img_prev: torch.Tensor,
    *,
    s: int,
    total_t: int,
    t_min: int = 0,
    reblurring: bool = True,
    omega: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    guidance_fn: Optional[GuidanceFn] = None,
    guidance_carry: Any = None,
    collect_interm: bool = False,
) -> Tuple[torch.Tensor, Any, Optional[Dict[str, torch.Tensor]]]:
    """Denoise at scale s from the (already resized) previous output:
    forward-noise it to ``total_t`` and reverse-denoise ``total_t-1 .. t_min``,
    with ``img_prev`` as the reblur anchor. Runs on ``img_prev``'s device.
    Returns (x, guidance_carry, aux)."""
    if noise_fn is None:
        noise_fn = make_noise_fn(generator, img_prev.device)
    noise = noise_fn(tuple(img_prev.shape)).to(device=img_prev.device, dtype=img_prev.dtype)
    x = q_sample(sched, img_prev, total_t, noise)
    return _reverse_loop(
        model_fn, sched, x, noise_fn, total_t, t_min,
        s=s, reblurring=reblurring, img_prev=img_prev, omega=omega,
        guidance_fn=guidance_fn, guidance_carry=guidance_carry,
        collect_interm=collect_interm,
    )
