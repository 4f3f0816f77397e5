"""Image-to-image applications: harmonization and style transfer (port of
``sinddm_tpu/apps/i2i.py``).

* style transfer: histogram-match the input to the training image of the
  entry scale, inject it there with a small starting t (the CLI's 15);
* harmonization: resize, dilate and feather the user's mask, inject the
  composite at the finest scale with starting t 5, then composite
  ``mask * sample + (1 - mask) * input`` at the end;
* both run the entry scale with its gamma row zeroed (no reblur mixing at
  injection, ``Schedules.zero_gamma_row``).

The walk runs at the input's own size, ``(int(h / f), int(w / f))`` with
``f = scale_factor ** (n_scales - s - 1)``, not at the pyramid's sizes.

Under a mesh (``sharding``) the denoiser is split over both axes
(:func:`~sinddm_tpu_torch.parallel.mesh.split_model_fn`), at any input
height: the slabs need not divide it, where the JAX package falls back to
sharding the batch alone when H does not divide by ``spatial``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sinddm_tpu_torch.diffusion.core import ModelFn, NoiseFn, make_noise_fn, sample_via_scale
from sinddm_tpu_torch.ops.image import dilate_mask, match_histograms
from sinddm_tpu_torch.ops.resize import resize_bilinear
from sinddm_tpu_torch.parallel.mesh import NamedSharding, require_named_sharding, split_model_fn
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import Schedules


def _to_u8(img_pm1: np.ndarray) -> np.ndarray:
    return np.clip((np.asarray(img_pm1) + 1) * 0.5 * 255 + 0.5, 0, 255).astype(np.uint8)


def prepare_i2i(
    pyramid: Pyramid,
    input_img: np.ndarray,
    *,
    mode: str,
    start_s: int,
    mask_img: Optional[np.ndarray] = None,
    use_hist: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The host preparation of :func:`image2image`: returns the input
    ([H, W, 3] float32 in [-1, 1], histogram-matched in uint8 to
    ``pyramid.images[start_s]`` when ``use_hist``) and the dilated mask
    ([H, W, 1] float32, harmonization with a mask only, else None)."""
    h_in, w_in = input_img.shape[:2]
    mask = None
    if mode == "harmonization" and mask_img is not None:
        from PIL import Image

        m = Image.fromarray(
            np.clip(np.asarray(mask_img) * 255, 0, 255).astype(np.uint8)
        ).resize((w_in, h_in), Image.LANCZOS)
        mask = dilate_mask(np.asarray(m, np.float32) / 255.0, mode=mode)
    if use_hist:
        matched = match_histograms(_to_u8(input_img), _to_u8(pyramid.images[start_s]))
        input_img = (matched.astype(np.float32) / 255.0) * 2.0 - 1.0
    return np.asarray(input_img, np.float32), mask


def image2image(
    model_fn: ModelFn,
    sched: Schedules,
    pyramid: Pyramid,
    input_img: np.ndarray,
    *,
    mode: str,
    mask_img: Optional[np.ndarray] = None,
    start_s: Optional[int] = None,
    custom_t: Optional[Sequence[int]] = None,
    batch_size: int = 16,
    use_hist: Optional[bool] = None,
    omega: float = 0.0,
    sample_limited_t: bool = False,
    collect_aux: Optional[List[Any]] = None,
    collect_interm: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    sharding: Optional[NamedSharding] = None,
    device="cuda",
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run ``mode`` ('harmonization' or 'style_transfer') from ``start_s``
    (default the finest scale) to the finest; returns (the final composite
    [B, H, W, 3] in [0, 1], the per-scale outputs in [-1, 1]).

    ``input_img``: [H, W, 3] float in [-1, 1] (already capped by
    :func:`sinddm_tpu_torch.pyramid.load_external_image`). ``mask_img``: the
    raw [H, W, C] mask in [0, 1] (harmonization only; resized and dilated
    here). ``custom_t[s]`` is the number of steps of scale s (indexed by s,
    not s - 1 as in ``sample_scales``). ``collect_interm`` appends each run
    scale's per-step frames to ``collect_aux`` under ``"interm"``. Noise comes
    from ``noise_fn`` when given, else from ``generator`` on ``device``.
    ``sharding`` splits each denoiser call over the mesh; every rank returns
    the whole outputs.
    """
    sharding = require_named_sharding(sharding)
    if sharding is not None:
        model_fn = split_model_fn(model_fn, sharding)
    n_scales = pyramid.n_scales
    if start_s is None:
        start_s = n_scales - 1
    if use_hist is None:
        use_hist = mode == "style_transfer"
    if custom_t is None:
        custom_t = list(sched.num_timesteps_ideal)
    if noise_fn is None:
        noise_fn = make_noise_fn(generator, device)

    h_in, w_in = input_img.shape[:2]
    input_img, mask_np = prepare_i2i(pyramid, input_img, mode=mode, start_s=start_s, mask_img=mask_img,
                                     use_hist=use_hist)
    mask = 1.0 if mask_np is None else torch.as_tensor(mask_np, device=device)[None]  # [1, H, W, 1]
    img = torch.as_tensor(input_img, device=device)
    input_batch = img[None].expand((batch_size,) + tuple(img.shape)).contiguous()

    # no reblur mixing at the entry scale
    sched_run = sched.zero_gamma_row(start_s) if start_s > 0 else sched

    outputs: List[torch.Tensor] = []
    prev = input_batch
    with torch.no_grad():
        for s in range(start_s, n_scales):
            ds_factor = pyramid.scale_factor ** (n_scales - s - 1)
            cur_size = (int(h_in / ds_factor), int(w_in / ds_factor))
            t_min = int(sched.num_timesteps_ideal[s + 1]) if (sample_limited_t and s < n_scales - 1) else 0
            x, _, aux = sample_via_scale(
                model_fn, sched_run, resize_bilinear(prev, cur_size), s=s, total_t=int(custom_t[s]),
                t_min=t_min, reblurring=True, omega=omega, noise_fn=noise_fn,
                collect_interm=collect_interm,
            )
            if collect_aux is not None:
                collect_aux.append(aux)
            outputs.append(x)
            prev = x

        final01 = (outputs[-1] + 1.0) * 0.5
        input01 = torch.clamp((input_batch + 1.0) * 0.5, 0.0, 1.0)
        final = mask * final01 + (1.0 - mask) * input01
    return final, outputs
