"""CLIP-guided sampling hook: gradient edits of x_recon inside the reverse loop
(port of ``sinddm_tpu/guidance/clip_guidance.py``).

Per guided timestep: clamp x_recon; if a mask exists, blend with the previous
guided estimate (``x (1-m) + ((1-l) prev + l x) m``); then ``sub_iters``
gradient sub-iterations: score = -clip_loss((x+1)/2, text embeddings); on the
first-ever iteration :func:`thresholded_grad` sparsifies the gradient at an
energy quantile (= 1 - fill_factor) and makes the persistent edit mask; then
the norm-matched update ``x += strength (||x m|| / ||g m||) g m`` and a clamp.
Guidance is off for the last ``stop_guidance`` steps of the finest scale.

The sampler runs without autograd; the gradient is taken on a detached leaf
under ``torch.enable_grad()`` and goes through the CLIP tower and the view
warp only, never the denoiser. The JAX package's ``lax.cond`` gates are
Python ``if``s on the step's integer ``t``; ``has_mask`` is a Python bool.
No device value is read on the host.

Carry: (mask [B,H,W,1], x_recon_prev [B,H,W,3], has_mask). The app layer
resizes it between scales (:func:`resize_guidance_carry`).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sinddm_tpu_torch.guidance.clip_extractor import ClipExtractor, LossDraws
from sinddm_tpu_torch.ops.resize import resize_bilinear

# draw_fn(batch, n_templates) -> the random numbers of one CLIP loss call
DrawFn = Callable[[int, int], LossDraws]


class ClipCarry(NamedTuple):
    mask: torch.Tensor  # [B, H, W, 1]
    x_recon_prev: torch.Tensor  # [B, H, W, 3]
    has_mask: bool


def init_clip_carry(batch: int, size_hw: Tuple[int, int], device="cuda") -> ClipCarry:
    h, w = size_hw
    return ClipCarry(
        mask=torch.zeros((batch, h, w, 1), dtype=torch.float32, device=device),
        x_recon_prev=torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device),
        has_mask=False,
    )


def resize_guidance_carry(carry: ClipCarry, size_hw: Tuple[int, int], drop_mask: bool = False) -> ClipCarry:
    """Bilinear-resize the guidance state to the next scale's size.
    ``drop_mask`` discards a mask made at scale 0 ("usually too noisy")."""
    b = carry.mask.shape[0]
    return ClipCarry(
        mask=torch.zeros((b, *size_hw, 1), dtype=carry.mask.dtype, device=carry.mask.device)
        if drop_mask else resize_bilinear(carry.mask, size_hw),
        x_recon_prev=resize_bilinear(carry.x_recon_prev, size_hw),
        has_mask=False if drop_mask else carry.has_mask,
    )


def nearest_quantile_index(quantile: float, n: int) -> int:
    """Index into the sorted values that ``jnp.quantile(..., method="nearest")``
    takes: the virtual index q (n-1), computed in float32, rounded to the
    nearest integer with .5 rounded DOWN (numpy and torch round it up)."""
    vi = np.float32(quantile) * np.float32(n - 1)
    return int(min(max(math.ceil(float(vi) - 0.5), 0), n - 1))


def thresholded_grad(grad: torch.Tensor, quantile: float = 0.8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-threshold CLIP gradients at an energy quantile: energy = the L2
    norm over channels; per sample the 'nearest' quantile q of the flattened
    energy; returns (grad scaled to energy - q where positive, else 0;
    boolean mask energy > q, [B, H, W, 1]). A zero-energy pixel gives 0."""
    b = grad.shape[0]
    energy = torch.linalg.vector_norm(grad, dim=-1)  # [B, H, W]
    flat = energy.reshape(b, -1)
    k = nearest_quantile_index(quantile, flat.shape[1])
    q = torch.sort(flat, dim=1).values[:, k][:, None, None]
    delta = energy - q
    mask = (delta > 0)[..., None]
    unit = torch.nan_to_num(grad / energy[..., None], nan=0.0, posinf=0.0, neginf=0.0)
    return delta.clamp_min(0.0)[..., None] * unit, mask


def _vec_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-sample L2 norm over (H, W, C), keepdims."""
    return torch.sqrt((x * x).sum(dim=(1, 2, 3), keepdim=True))


def make_clip_guidance(
    extractor: ClipExtractor,
    text_embeds: torch.Tensor,
    *,
    s: int,
    n_scales: int,
    sub_iters: int,
    strength: float,
    quantile: float,
    llambda: float,
    stop_guidance: int,
    draw_fn: Optional[DrawFn] = None,
):
    """Build the per-scale guidance hook (None when sub_iters == 0):
    ``guidance_fn(x_recon, x_t, t, s, carry) -> (x_recon, carry, aux)`` with
    ``t`` and ``s`` Python ints and ``aux = {"clip_score": [sub_iters]}``
    (zeros on a gated step). ``draw_fn`` supplies each loss call's random
    numbers; by default the extractor draws them from its generator."""
    if sub_iters <= 0:
        return None
    if draw_fn is None:
        draw_fn = extractor.draw
    n_templates = text_embeds.shape[0]

    def guidance_fn(x_recon, x_t, t: int, s_: int, carry: ClipCarry):
        # gate: guide at every coarser scale, and at the finest while t >= stop_guidance
        if not (s < n_scales - 1 or int(t) >= stop_guidance):
            return x_recon, carry, {"clip_score": torch.zeros((sub_iters,), device=x_recon.device)}
        mask, x_prev, has_mask = carry
        x = x_recon.detach().clamp(-1.0, 1.0)
        if has_mask:
            x = x * (1.0 - mask) + ((1.0 - llambda) * x_prev + llambda * x) * mask

        scores = []
        for _ in range(sub_iters):
            loss, grad01 = extractor.clip_loss_and_grad(
                (x + 1.0) * 0.5, text_embeds, draw_fn(x.shape[0], n_templates))
            grad = -0.5 * grad01  # d(-loss((x + 1) / 2)) / dx
            if not has_mask:  # first-ever iteration: sparsify, and fix the edit mask
                grad, new_mask = thresholded_grad(grad, quantile)
                mask = new_mask.to(torch.float32)
                has_mask = True
            division_norm = _vec_norm(x * mask) / _vec_norm(grad * mask).clamp_min(1e-12)
            x = (x + strength * division_norm * grad * mask).clamp(-1.0, 1.0)
            scores.append(-loss)
        return x, ClipCarry(mask, x, has_mask), {"clip_score": torch.stack(scores)}

    return guidance_fn
