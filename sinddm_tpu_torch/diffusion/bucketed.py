"""The shape-bucketed via-scale sampler (port of ``sinddm_tpu/diffusion/bucketed.py``).

The JAX package runs every via scale of a guided walk on ONE padded canvas,
the finest scale's shape, so that one XLA program serves them all: the
scale's size becomes a traced value, and the valid region (top-left) a mask.
PyTorch compiles nothing, so the canvas saves nothing here; the port keeps
the walk's semantics, so that it samples the JAX bucketed walk's process
draw for draw:

* the state is the canvas [B, H, W, 3], zero outside the valid region: the
  previous output resized valid region to valid region
  (:func:`dynamic_resize_into_canvas`), forward-noised, and each reverse
  step's result multiplied by the valid mask;
* every draw is canvas-shaped (the initial one, then one a step), from
  ``noise_fn`` or ``generator``;
* steps with ``t < t_min`` are skipped (``--sample_limited_t``);
* the CLIP hook crops its views from the valid region into the canvas's
  fixed frame, reading the whole canvas, and takes its quantile over the
  valid pixels (``guidance/clip_guidance.py`` ``make_clip_guidance(valid_hw=,
  frame_hw=)``).

What it does not keep is the padded work: the denoiser runs on the valid
crop ``x[:, :h, :w]`` and its output is zero-padded back
(:func:`crop_model_fn`). That equals the JAX package's valid-mask mode on
the valid region (the state is zero outside it, and a masked 'SAME' conv
sees the zeros the crop's padding gives; ``models/denoiser.py``), and zero
outside it.

The JAX package's ``seg_len`` (``--guidance_seg_len``) cuts the chain into
device calls of a bounded length. The port runs a step a call, so it has no
such argument; its CLI takes the flag and ignores it.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sinddm_tpu_torch.diffusion.core import GuidanceFn, ModelFn, NoiseFn, make_noise_fn, p_sample_step, q_sample
from sinddm_tpu_torch.schedules import Schedules


def valid_mask_2d(canvas_hw: Tuple[int, int], valid_hw: Tuple[int, int], device="cuda") -> torch.Tensor:
    """[H, W] bool mask of the top-left ``valid_hw`` region of the canvas."""
    h, w = canvas_hw
    ys = torch.arange(h, device=device)[:, None] < int(valid_hw[0])
    xs = torch.arange(w, device=device)[None, :] < int(valid_hw[1])
    return ys & xs


def dynamic_resize_into_canvas(x: torch.Tensor, src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize the top-left ``src_hw`` region of a canvas [B, H, W, C]
    to its top-left ``dst_hw`` region, zeros elsewhere: half-pixel centres, no
    antialias, sample positions clamped into the source's valid region
    (``F.interpolate(bilinear)``'s sampling), in float32 as the JAX package
    computes it. Not ``F.interpolate`` of the whole canvas: the padding must
    not leak in."""
    _, H, W, _ = x.shape
    sh, sw, dh, dw = (np.float32(v) for v in (*src_hw, *dst_hw))

    def axis(n_out, s, d):
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * float(s / d) - 0.5
        pos = pos.clamp(0.0, float(s - 1))
        i0 = torch.floor(pos)
        frac = pos - i0
        i0 = i0.long()
        return i0, torch.clamp(i0 + 1, max=int(s) - 1), frac

    y0, y1, wy = axis(H, sh, dh)
    x0, x1, wx = axis(W, sw, dw)
    wy, wx = wy[None, :, None, None], wx[None, None, :, None]
    g = lambda yi, xi: x[:, yi][:, :, xi]  # noqa: E731
    out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
           + g(y1, x0) * wy * (1 - wx) + g(y1, x1) * wy * wx)
    return out * valid_mask_2d((H, W), dst_hw, x.device)[None, :, :, None].to(out.dtype)


def place_on_canvas(x: torch.Tensor, canvas_hw: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad [B, h, w, C] into the top-left of [B, H, W, C]."""
    return F.pad(x, (0, 0, 0, canvas_hw[1] - x.shape[2], 0, canvas_hw[0] - x.shape[1]))


def crop_model_fn(model_fn: ModelFn, valid_hw: Tuple[int, int]) -> ModelFn:
    """``model_fn`` on the valid crop of a canvas, zero-padded back: on a
    state that is zero outside the valid region, the JAX package's
    valid-mask denoiser call without the padded work."""
    h, w = (int(v) for v in valid_hw)

    def fn(x, t_vec, s_vec):
        eps = model_fn(x[:, :h, :w].contiguous(), t_vec, s_vec)
        return place_on_canvas(eps, tuple(x.shape[1:3]))

    return fn


def sample_via_scale_bucketed(
    model_fn: ModelFn,
    sched: Schedules,
    prev_canvas: torch.Tensor,
    *,
    prev_valid_hw: Tuple[int, int],
    cur_valid_hw: Tuple[int, int],
    s: int,
    total_t: int,
    t_min: int = 0,
    reblurring: bool = True,
    omega: float = 0.0,
    guidance_fn: Optional[GuidanceFn] = None,
    guidance_carry: Any = None,
    collect_interm: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    device="cuda",
) -> Tuple[torch.Tensor, Any, Optional[dict]]:
    """Reverse-denoise one via scale ``s`` on the canvas of ``prev_canvas``
    (the previous scale's output in its top-left ``prev_valid_hw``).

    The chain's steps are j = 0 .. total_t - 1 - t_min, at t = total_t - 1 - j.
    The state starts as q_sample of the resized previous output at
    ``total_t``, times the valid mask. ``model_fn`` is the plain denoiser; it
    runs on the valid crop (:func:`crop_model_fn`).

    Returns (canvas state, guidance carry, aux): aux stacks each step's
    guidance aux ([n_steps, ...]) and, with ``collect_interm``, every state
    under ``"interm"`` (canvas-shaped); None when there is neither. The JAX
    package pads its score rows to the longest chain of the walk with
    zeros; here there is a row a step of this chain. The chain runs on
    ``device``.
    """
    prev_canvas = prev_canvas.to(device)
    if noise_fn is None:
        noise_fn = make_noise_fn(generator, device)
    canvas_hw = tuple(prev_canvas.shape[1:3])
    mask4 = valid_mask_2d(canvas_hw, cur_valid_hw, prev_canvas.device)[None, :, :, None].to(prev_canvas.dtype)
    img_prev = dynamic_resize_into_canvas(prev_canvas, prev_valid_hw, cur_valid_hw)
    noise = noise_fn(tuple(img_prev.shape)).to(device=img_prev.device, dtype=img_prev.dtype)
    x = q_sample(sched, img_prev, total_t, noise) * mask4
    model_crop = crop_model_fn(model_fn, cur_valid_hw)
    rows: dict = {}
    for j in range(total_t - t_min):
        x, guidance_carry, step_aux = p_sample_step(
            model_crop, sched, x, total_t - 1 - j, noise_fn,
            s=s, reblurring=reblurring, img_prev=img_prev, omega=omega,
            guidance_fn=guidance_fn, guidance_carry=guidance_carry,
        )
        x = x * mask4
        if collect_interm:
            step_aux = dict(step_aux, interm=x)
        for name, value in step_aux.items():
            rows.setdefault(name, []).append(value)
    aux = {name: torch.stack(values) for name, values in rows.items()} or None
    return x, guidance_carry, aux
