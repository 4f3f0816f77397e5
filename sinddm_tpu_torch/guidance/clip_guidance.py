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

Under a mesh (``sharding``) the CLIP loss and its gradient, most of a guided
step, are split over the ``data`` axis (:func:`clip_loss_and_grad`): a rank
takes its images and their rows of the whole batch's view draws, and the
gradient is gathered. The loss is a sum over images, so the ranks' losses
add up to it. The rest of the step (the threshold, the norm match) is per
sample and runs whole on every rank.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sinddm_tpu_torch.diffusion.bucketed import valid_mask_2d
from sinddm_tpu_torch.guidance.clip_extractor import ClipExtractor, LossDraws
from sinddm_tpu_torch.ops.resize import resize_bilinear
from sinddm_tpu_torch.parallel.mesh import DATA_AXIS, NamedSharding, gather_block, split_range

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


def thresholded_grad(grad: torch.Tensor, quantile: float = 0.8, valid_mask: Optional[torch.Tensor] = None,
                     n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-threshold CLIP gradients at an energy quantile: energy = the L2
    norm over channels; per sample the 'nearest' quantile q of the flattened
    energy; returns (grad scaled to energy - q where positive, else 0;
    boolean mask energy > q, [B, H, W, 1]). A zero-energy pixel gives 0.

    ``valid_mask`` ([H, W] bool) with ``n_valid`` (its count) takes the
    quantile over the valid region of a padded canvas only: the other
    energies sort to +inf, and both outputs are zero outside it."""
    b = grad.shape[0]
    energy = torch.linalg.vector_norm(grad, dim=-1)  # [B, H, W]
    flat = energy.reshape(b, -1)
    if valid_mask is None:
        k = nearest_quantile_index(quantile, flat.shape[1])
    else:
        flat = torch.where(valid_mask.reshape(1, -1), flat, torch.full_like(flat, float("inf")))
        k = nearest_quantile_index(quantile, int(n_valid))
    q = torch.sort(flat, dim=1).values[:, k][:, None, None]
    delta = energy - q
    mask = (delta > 0)[..., None]
    unit = torch.nan_to_num(grad / energy[..., None], nan=0.0, posinf=0.0, neginf=0.0)
    sparse = delta.clamp_min(0.0)[..., None] * unit
    if valid_mask is not None:
        mask = mask & valid_mask[None, :, :, None]
        sparse = sparse * valid_mask[None, :, :, None]
    return sparse, mask


def clip_loss_and_grad(extractor: ClipExtractor, x01: torch.Tensor, text_embeds: torch.Tensor, draws: LossDraws,
                       sharding: Optional[NamedSharding] = None, **region) -> Tuple[torch.Tensor, torch.Tensor]:
    """:meth:`ClipExtractor.clip_loss_and_grad` of the batch ``x01`` with the
    whole batch's ``draws``, split over ``sharding``'s ``data`` axis: each
    rank computes its images with their rows of the draws, the losses are
    summed and the gradient gathered over the axis. Every rank gets the
    whole batch's loss and gradient."""
    group = None
    if sharding is not None and sharding.axis(0) == DATA_AXIS:
        group = sharding.mesh.group(DATA_AXIS)
    if group is None:
        return extractor.clip_loss_and_grad(x01, text_embeds, draws, **region)
    b = x01.shape[0]
    lo, hi = split_range(b, *sharding.parts(0))
    if hi > lo:
        loss, grad = extractor.clip_loss_and_grad(x01[lo:hi], text_embeds, draws.rows(lo, hi), **region)
    else:  # more ranks than images
        loss, grad = x01.new_zeros(()), x01.new_zeros((0,) + tuple(x01.shape[1:]))
    loss = loss.clone()
    dist.all_reduce(loss, group=group)
    return loss, gather_block(grad, x01.shape, (slice(lo, hi),), group)


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
    valid_hw: Optional[Tuple[int, int]] = None,
    frame_hw: Optional[Tuple[int, int]] = None,
    sharding: Optional[NamedSharding] = None,
):
    """Build the per-scale guidance hook (None when sub_iters == 0):
    ``guidance_fn(x_recon, x_t, t, s, carry) -> (x_recon, carry, aux)`` with
    ``t`` and ``s`` Python ints and ``aux = {"clip_score": [sub_iters]}``
    (zeros on a gated step). ``draw_fn`` supplies each loss call's random
    numbers; by default the extractor draws them from its generator.

    The bucketed walk (``diffusion/bucketed.py``) passes ``valid_hw``, the
    image's top-left region of the padded canvas, and ``frame_hw``, the
    views' fixed frame: the views are cropped from the valid region, the
    gradient is zeroed outside it (a bilinear tap at its edge can reach the
    first padded row or column), and the quantile is taken over its pixels.
    ``sharding`` splits the CLIP loss over its ``data`` axis
    (:func:`clip_loss_and_grad`); ``draw_fn`` draws for the whole batch."""
    if sub_iters <= 0:
        return None
    if draw_fn is None:
        draw_fn = extractor.draw
    n_templates = text_embeds.shape[0]
    region = {} if valid_hw is None else dict(valid_hw=tuple(valid_hw), frame_hw=tuple(frame_hw))

    def guidance_fn(x_recon, x_t, t: int, s_: int, carry: ClipCarry):
        # gate: guide at every coarser scale, and at the finest while t >= stop_guidance
        if not (s < n_scales - 1 or int(t) >= stop_guidance):
            return x_recon, carry, {"clip_score": torch.zeros((sub_iters,), device=x_recon.device)}
        mask, x_prev, has_mask = carry
        x = x_recon.detach().clamp(-1.0, 1.0)
        if has_mask:
            x = x * (1.0 - mask) + ((1.0 - llambda) * x_prev + llambda * x) * mask

        valid = {}
        if valid_hw is not None:
            vmask = valid_mask_2d(tuple(x.shape[1:3]), valid_hw, x.device)
            valid = dict(valid_mask=vmask, n_valid=valid_hw[0] * valid_hw[1])
        scores = []
        for _ in range(sub_iters):
            loss, grad01 = clip_loss_and_grad(
                extractor, (x + 1.0) * 0.5, text_embeds, draw_fn(x.shape[0], n_templates), sharding, **region)
            grad = -0.5 * grad01  # d(-loss((x + 1) / 2)) / dx
            if valid:
                grad = grad * valid["valid_mask"][None, :, :, None]
            if not has_mask:  # first-ever iteration: sparsify, and fix the edit mask
                grad, new_mask = thresholded_grad(grad, quantile, **valid)
                mask = new_mask.to(torch.float32)
                has_mask = True
            division_norm = _vec_norm(x * mask) / _vec_norm(grad * mask).clamp_min(1e-12)
            x = (x + strength * division_norm * grad * mask).clamp(-1.0, 1.0)
            scores.append(-loss)
        return x, ClipCarry(mask, x, has_mask), {"clip_score": torch.stack(scores)}

    return guidance_fn
