"""ROI-guided generation (port of ``sinddm_tpu/apps/roi.py``): the plain
pyramid walk with the ROI paste hook of :mod:`sinddm_tpu_torch.guidance.roi`
at every scale below the finest. Boxes are [y, x, h, w] at finest-scale
coordinates. Under a mesh (``sharding``) the denoiser is split as
``sample_scales`` splits it; the pastes are pointwise and run whole on
every rank."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from sinddm_tpu_torch.apps.sampling import sample_scales
from sinddm_tpu_torch.diffusion.core import ModelFn, NoiseFn
from sinddm_tpu_torch.guidance.roi import make_roi_guidance
from sinddm_tpu_torch.parallel.mesh import NamedSharding
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import Schedules


def roi_guided_sampling(
    model_fn: ModelFn,
    sched: Schedules,
    pyramid: Pyramid,
    *,
    target_roi: Sequence[int],
    roi_bb_list: Sequence[Sequence[int]],
    custom_t_list: Optional[Sequence[int]] = None,
    batch_size: int = 4,
    scale_mul: Tuple[float, float] = (1.0, 1.0),
    reblurring: bool = True,
    sample_limited_t: bool = False,
    omega: float = 0.0,
    collect_aux: Optional[List[Any]] = None,
    collect_interm: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
    sharding: Optional[NamedSharding] = None,
    device="cuda",
) -> List[torch.Tensor]:
    """Sample the pyramid with ``target_roi``'s patch pasted into each box of
    ``roi_bb_list``; returns the per-scale outputs [B, H, W, 3] in [-1, 1]."""
    def guidance_factory(s, size_hw):
        fn = make_roi_guidance(
            pyramid.images, target_roi, roi_bb_list, scale_factor=pyramid.scale_factor,
            n_scales=pyramid.n_scales, s=s, device=device,
        )
        return fn, None  # ROI guidance is stateless

    return sample_scales(
        model_fn, sched, pyramid.sizes_hw, scale_factor=pyramid.scale_factor, n_scales=pyramid.n_scales,
        batch_size=batch_size, scale_mul=scale_mul, custom_t_list=custom_t_list, custom_sample=False,
        reblurring=reblurring, omega=omega, sample_limited_t=sample_limited_t,
        guidance_factory=guidance_factory, collect_aux=collect_aux, collect_interm=collect_interm,
        generator=generator, noise_fn=noise_fn, sharding=sharding, device=device,
    )
