"""Plain PyTorch reference of SinDDM: the schedules, the pyramid geometry,
the denoiser, the reblurred pyramid walk and the training step with Adam.

Written from the SinDDM paper (Kulikov et al., "SinDDM: A Single Image
Denoising Diffusion Model", ICML 2023) and its reference code
(github.com/fallenshock/SinDDM: ``SinDDM/models.py``, ``SinDDM/functions.py``,
``main.py``). It imports torch and numpy only: nothing of the program under
test, nothing of JAX. Every derived quantity (betas, the per-scale starting
timesteps, the reblur rows, the scale sizes, the scale order and the draws of
a train step) is worked out here again.

Layouts: images NHWC in [-1, 1]; the weights are a dict of tensors named and
laid out as the benchmark makes them (``yardstick/weights.py``): convs HWIO
(``[kh, kw, Cin, Cout]``, the depthwise ``[5, 5, 1, C]``), dense layers
``[out, in]``. The computation runs NCHW through ``F.conv2d`` in float32.

Precision: :func:`precision` sets cuDNN's and cuBLAS's TF32 switches for a
scope. The reference proper runs with TF32 off (true fp32), as the
configuration states; the control of the benchmark's check runs the same
code with TF32 on.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GAMMA_SAMPLING_MAX = 0.55  # the reblur rows are clamped to this at sampling time
AREA_SCALE_0, SCALE_0_MIN, SCALE_0_MAX = 3110, 42, 55


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN convolutions and cuBLAS products in TF32 (``tf32``) or in true fp32."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


# ---- schedules and geometry -------------------------------------------------

def geometry(image_wh: Sequence[int], scale_factor: float, auto_scale: Optional[int]) -> dict:
    """Scale sizes of the pyramid (SinDDM ``main.py``): the image capped at
    ``auto_scale`` pixels, the coarsest short side ~sqrt(3110 * short / long)
    clamped to [42, 55], as many scales as ``scale_factor`` gives, the exact
    factor re-derived so that the finest scale is the image."""
    w, h = int(image_wh[0]), int(image_wh[1])
    if auto_scale is not None and w * h > auto_scale:
        r = math.sqrt(w * h / auto_scale)
        w, h = int(w / r), int(h / r)
    short, long_ = min(w, h), max(w, h)
    s0 = min(max(int(round(math.sqrt(AREA_SCALE_0 * short / long_))), SCALE_0_MIN), SCALE_0_MAX)
    n = int(round(math.log(short / s0) / math.log(scale_factor))) + 1
    factor = math.exp(math.log(short / s0) / (n - 1))
    sizes_hw = [(int(round(h / factor ** (n - 1 - i))), int(round(w / factor ** (n - 1 - i)))) for i in range(n)]
    return {"sizes_hw": sizes_hw, "n_scales": n, "scale_factor": factor}


def schedules(timesteps: int, rescale_losses: Sequence[float], device) -> dict:
    """The cosine schedule (s = 0.008, betas clipped at 0.999) and SinDDM's
    per-scale quantities, in float64, then float32 on ``device``:
    ``ideal[i + 1] = first t with sigma_t > loss_i``, the reblur rows
    ``gamma[i][t] = clip(sigma_t / loss_i, 0, 1)``."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    ac = np.cos(((x / steps) + 0.008) / 1.008 * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    abar = np.cumprod(1.0 - betas)
    abar_prev = np.append(1.0, abar[:-1])
    post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
    sigma = np.sqrt(1.0 - abar) / np.sqrt(abar)
    ideal = [timesteps] + [int(np.argmax(sigma > loss)) for loss in rescale_losses]
    gammas = np.stack([np.clip(sigma / loss, 0.0, 1.0) for loss in rescale_losses])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float64).astype(np.float32), device=device)  # noqa: E731
    return {
        "T": timesteps, "ideal": ideal,
        "sqrt_abar": f32(np.sqrt(abar)), "sqrt_1m_abar": f32(np.sqrt(1.0 - abar)),
        "abar": f32(abar),
        "recip": f32(np.sqrt(1.0 / abar)), "recipm1": f32(np.sqrt(1.0 / abar - 1.0)),
        "coef1": f32(betas * np.sqrt(abar_prev) / (1.0 - abar)),
        "coef2": f32((1.0 - abar_prev) * np.sqrt(1.0 - betas) / (1.0 - abar)),
        "logvar": f32(np.log(np.maximum(post_var, 1e-20))),
        "gammas": f32(gammas),
    }


def _at(a: torch.Tensor, t: int) -> torch.Tensor:
    """A schedule entry at step ``t`` (clamped to the last), shaped to broadcast over NHWC."""
    return a[min(int(t), a.shape[0] - 1)].reshape(1, 1, 1, 1)


def _at_vec(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return a[t.clamp(max=a.shape[0] - 1)].reshape(-1, 1, 1, 1)


# ---- the denoiser -----------------------------------------------------------

def _emb(v: torch.Tensor, width: int) -> torch.Tensor:
    half = width // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=v.device) * -(math.log(10000.0) / (half - 1)))
    a = v.float()[:, None] * freqs[None]
    return torch.cat([a.sin(), a.cos()], dim=1)


def _dense(x, w, name):
    return F.linear(x, w[name + ".weight"], w[name + ".bias"])


def denoise(w: Dict[str, torch.Tensor], x: torch.Tensor, t: torch.Tensor, s: torch.Tensor,
            blocks: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The SinDDM network on NHWC ``x`` at timesteps ``t`` [B] and scale ``s`` [B]:
    the (t, s) sinusoidal embeddings through Linear-GELU-Linear; four blocks,
    each a depthwise 5x5 plus the block's projection of the condition, then
    3x3 - GELU - 3x3, plus a 1x1 residual where the widths differ (else the
    identity); a final 1x1. Exact (erf) GELU. The embeddings' width is the
    configuration's time dimension, as the weights were made to it."""
    gelu = lambda v: F.gelu(v, approximate="none")  # noqa: E731
    width = w["time_mlp1.weight"].shape[1] // 2
    cond = _dense(gelu(_dense(torch.cat([_emb(t, width), _emb(s, width)], 1), w, "time_mlp1")), w, "time_mlp2")
    h = x.permute(0, 3, 1, 2)
    for i, (c, co) in enumerate(blocks):
        p = f"l{i + 1}."
        cv = _dense(_dense(gelu(cond), w, p + "cond_mlp"), w, p + "cond_proj")
        dw = w[p + "ds_conv.weight"].permute(3, 2, 0, 1)  # [C, 1, 5, 5]
        y = F.conv2d(h, dw, w[p + "ds_conv.bias"], padding=2, groups=c) + cv[:, :, None, None]
        y = gelu(F.conv2d(y, w[p + "net_conv1.weight"].permute(3, 2, 0, 1), w[p + "net_conv1.bias"], padding=1))
        y = F.conv2d(y, w[p + "net_conv2.weight"].permute(3, 2, 0, 1), w[p + "net_conv2.bias"], padding=1)
        if c != co:
            res = F.conv2d(h, w[p + "res_conv.weight"].permute(3, 2, 0, 1), w[p + "res_conv.bias"])
        else:
            res = h
        h = y + res
    out = F.conv2d(h, w["final_conv.weight"].permute(3, 2, 0, 1), w["final_conv.bias"])
    return out.permute(0, 2, 3, 1)


# ---- the walk ---------------------------------------------------------------

def resize(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear, half-pixel centres, no antialiasing (PyTorch's
    ``interpolate(align_corners=False)``, SinDDM's upsampling between scales)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size_hw), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def reverse_step(net: Callable, sch: dict, x: torch.Tensor, t: int, s: int, noise: Callable,
                 img_prev: Optional[torch.Tensor], omega: float) -> torch.Tensor:
    """One step x_t -> x_{t-1}; draws one noise tensor, at t = 0 too.

    Scale 0: DDPM, x0 = x_t / sqrt(abar) - sqrt(1/abar - 1) eps, clipped,
    and the posterior mean with the clipped posterior log-variance.
    Scale s > 0 (reblurring): with gamma_t the clamped reblur row, the
    deblurred estimate (x0 - gamma_t prev) / (1 - gamma_t), re-blurred with
    gamma_{t-1} for t > 0, clipped; the mean sqrt(abar_{t-1}) x0_mix +
    sqrt(1 - abar_{t-1} - var) (x_t - sqrt(abar_t) x0) / sqrt(1 - abar_t),
    var = omega (1 - abar_{t-1}), log-variance log(max(var, 1e-20)); at
    t = 0 the mean is the estimate itself."""
    b = x.shape[0]
    eps = net(x, torch.full((b,), t, dtype=torch.long, device=x.device),
              torch.full((b,), float(s), device=x.device))
    x0 = _at(sch["recip"], t) * x - _at(sch["recipm1"], t) * eps
    if s == 0:
        x0 = x0.clamp(-1.0, 1.0)
        mean = _at(sch["coef1"], t) * x0 + _at(sch["coef2"], t) * x
        logvar = _at(sch["logvar"], t)
    else:
        row = sch["gammas"][s - 1].clamp(0.0, GAMMA_SAMPLING_MAX)
        g = _at(row, t)
        mix = (x0 - g * img_prev) / (1.0 - g)
        if t > 0:
            gp = _at(row, t - 1)
            mix = gp * img_prev + (1.0 - gp) * mix
        mix, x0 = mix.clamp(-1.0, 1.0), x0.clamp(-1.0, 1.0)
        if t > 0:
            abar_prev = _at(sch["abar"], t - 1)
            var = omega * (1.0 - abar_prev)
            mean = (abar_prev.sqrt() * mix
                    + (1.0 - abar_prev - var).sqrt() * (x - _at(sch["sqrt_abar"], t) * x0) / _at(sch["sqrt_1m_abar"], t))
            logvar = torch.log(torch.clamp(var, min=1e-20))
        else:
            mean, logvar = mix, _at(sch["logvar"], t)
    z = noise(tuple(x.shape))
    return mean + (torch.exp(0.5 * logvar) * z if t > 0 else 0.0 * z)


def walk(net: Callable, sch: dict, sizes_hw: Sequence[Tuple[int, int]], batch: int, noise: Callable, *,
         channels: int, omega: float = 0.0, device="cuda",
         step_fault: Optional[Callable] = None) -> List[torch.Tensor]:
    """The pyramid walk of ``batch`` images of ``channels`` channels: scale 0
    from pure noise over T steps, then each finer scale from the bilinear upsample of the last output, noised to its
    starting timestep ``ideal[s]`` and denoised over that many reblurred
    steps. Returns each scale's output [B, H, W, 3]. ``step_fault(s, t, x_in,
    x_out)`` may replace a step's output (the benchmark's planted faults)."""
    outs: List[torch.Tensor] = []
    with torch.no_grad():
        h, w = sizes_hw[0]
        x = noise((batch, h, w, channels))
        for s, size in enumerate(sizes_hw):
            prev = None
            if s > 0:
                prev = resize(outs[-1], size)
                t0 = sch["ideal"][s]
                x = _at(sch["sqrt_abar"], t0) * prev + _at(sch["sqrt_1m_abar"], t0) * noise(tuple(prev.shape))
            for t in range((sch["T"] if s == 0 else sch["ideal"][s]) - 1, -1, -1):
                y = reverse_step(net, sch, x, t, s, noise, prev, omega)
                x = y if step_fault is None else step_fault(s, t, x, y)
            outs.append(x)
    return outs


# ---- training ---------------------------------------------------------------

def chunk_scales(seed: int, n_scales: int, chunks: Sequence[int]) -> List[int]:
    """The scale of every step of grouped chunks of ``chunks[0]``,
    ``chunks[1]``, ... steps: each chunk visits the scales in the order of a
    permutation from numpy's default generator seeded ``seed + 1``,
    ``chunk // n_scales`` steps each (at least one), the last taking what is
    left (the repository's grouped chunk: PARITY.md deviation 2)."""
    rng = np.random.default_rng(seed + 1)
    out: List[int] = []
    for chunk in chunks:
        per = max(chunk // n_scales, 1)
        done = 0
        for i, s in enumerate(rng.permutation(n_scales)):
            k = min(per if i < n_scales - 1 else chunk - done, chunk - done)
            out += [int(s)] * max(k, 0)
            done += max(k, 0)
    return out


def train_loss(net: Callable, sch: dict, x_orig: torch.Tensor, x_blur: torch.Tensor, s: int,
               t: torch.Tensor, noise: torch.Tensor, rows: Optional[slice] = None) -> torch.Tensor:
    """SinDDM's L1 loss of one batch at scale ``s``: the target mixes the
    upsampled coarser image into the scale's image by the unclamped reblur
    row, ``gamma_t blur + (1 - gamma_t) orig`` (scale 0: the image), noised
    to t; the mean |noise - eps_pred| over the batch (``rows`` of it, the
    benchmark's half-batch fault)."""
    if s > 0:
        g = _at_vec(sch["gammas"][s - 1], t)
        mix = g * x_blur + (1.0 - g) * x_orig
    else:
        mix = x_orig.expand(t.shape[0], -1, -1, -1)
    xn = _at_vec(sch["sqrt_abar"], t) * mix + _at_vec(sch["sqrt_1m_abar"], t) * noise
    pred = net(xn, t, torch.full((t.shape[0],), float(s), device=t.device))
    err = (noise - pred).abs()
    return (err if rows is None else err[rows]).mean()


def adam_(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict, lr: float,
          betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam update in place: m, v moving averages of g and g^2, bias
    corrected at the state's step count, p -= lr m_hat / (sqrt(v_hat) + eps)."""
    state["step"] += 1
    k = state["step"]
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        m = state["m"][name].mul_(b1).add_(g, alpha=1 - b1)
        v = state["v"][name].mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * (m / (1 - b1 ** k)) / ((v / (1 - b2 ** k)).sqrt() + eps))


def lr_at(step: int, lr0: float, milestones: Sequence[int], gamma: float) -> float:
    """The learning rate of update ``step`` (counted from 0): halved at each milestone passed."""
    return lr0 * gamma ** sum(1 for m in milestones if m <= step)


def train_steps(weights: Dict[str, torch.Tensor], blocks, sch: dict,
                images: Sequence[Tuple[torch.Tensor, torch.Tensor]], scales: Sequence[int], draws: Callable,
                train: dict, state: Optional[dict] = None, rows: Optional[slice] = None) -> dict:
    """One SinDDM train step at each scale of ``scales`` from ``weights`` (and
    Adam's ``state``: ``m``, ``v``, ``step``; fresh when None), on ``images``
    (a scale's (image, upsampled coarser image)): each draws its (t, noise)
    from ``draws(s)``, takes the loss's gradient and one Adam update at the
    step's learning rate. Returns the losses, each step's gradients, the
    parameters and the state after the steps."""
    params = {k: v.detach().clone() for k, v in weights.items()}
    if state is None:
        state = {"step": 0, "m": {k: torch.zeros_like(v) for k, v in params.items()},
                 "v": {k: torch.zeros_like(v) for k, v in params.items()}}
    else:
        state = {"step": int(state["step"]), "m": {k: v.clone() for k, v in state["m"].items()},
                 "v": {k: v.clone() for k, v in state["v"].items()}}
    losses, grads_all = [], []
    for s in scales:
        x_orig, x_blur = images[s]
        t, noise = draws(s)
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = train_loss(lambda x, tt, ss: denoise(leaves, x, tt, ss, blocks), sch, x_orig, x_blur, s, t, noise,
                          rows)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            adam_(params, grads, state, lr_at(state["step"], train["lr"], train["sched_milestones"],
                                              train["lr_gamma"]), tuple(train["betas"]), train["eps"])
        losses.append(float(loss.detach()))
        grads_all.append(grads)
    return {"losses": losses, "grads": grads_all, "params": params, "state": state}
