"""ROI-guided sampling: paste a user-selected patch during denoising (port of
``sinddm_tpu/guidance/roi.py``).

The user picks a source box on the finest training image and one or more
target boxes. At every denoising step of every scale below the finest, the
scale's crop of the source box, nearest-resized into each target box, is
blended with weight eta = 0.8 into the step's predicted clean image.

Boxes are [y, x, h, w] at finest-scale coordinates. The box helpers are
numpy; the hook's pastes are built once a scale, on the device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sinddm_tpu_torch.diffusion.core import GuidanceFn
from sinddm_tpu_torch.ops.resize import resize_nearest


def rescale_bb(bb: Sequence[int], scale_factor: float, n_scales: int, s: int) -> List[int]:
    """Rescale a finest-scale [y, x, h, w] box to scale s."""
    f = np.power(scale_factor, n_scales - s - 1)
    return [int(v / f) for v in bb]


def extract_patch(image_hwc: np.ndarray, bb: Sequence[int]) -> np.ndarray:
    """The [y, x, h, w] crop of an [H, W, C] image."""
    y, x, h, w = bb
    return image_hwc[y : y + h, x : x + w]


def stat_from_bb(image_hwc: np.ndarray, bb: Sequence[int]):
    """Per-channel (mean, std with ddof=1) of a box, each [1, 1, C]."""
    patch = extract_patch(np.asarray(image_hwc), bb)
    return (
        patch.mean(axis=(0, 1), keepdims=True),
        patch.std(axis=(0, 1), ddof=1, keepdims=True),
    )


def make_roi_guidance(
    pyramid_images: Sequence[np.ndarray],
    target_bb: Sequence[int],
    roi_bbs: Sequence[Sequence[int]],
    *,
    scale_factor: float,
    n_scales: int,
    s: int,
    eta: float = 0.8,
    device="cuda",
) -> Optional[GuidanceFn]:
    """The guidance hook of scale s, or None at the finest scale.

    ``pyramid_images[s]`` is the scale-s training image [H, W, 3] in
    [-1, 1]; ``target_bb`` (the source box) and ``roi_bbs`` (the boxes it is
    pasted into) are finest-scale [y, x, h, w]. The hook blends into a copy
    of ``x_recon`` and returns it with the carry untouched and no aux.
    """
    if s >= n_scales - 1:
        return None

    tgt_bb_s = rescale_bb(target_bb, scale_factor, n_scales, s)
    target_patch = torch.as_tensor(
        np.asarray(extract_patch(np.asarray(pyramid_images[s]), tgt_bb_s), np.float32), device=device
    )[None]  # [1, h, w, 3]

    pastes: List[Tuple[int, int, torch.Tensor]] = []
    for bb in roi_bbs:
        y, x, h, w = rescale_bb(bb, scale_factor, n_scales, s)
        pastes.append((y, x, resize_nearest(target_patch, (h, w))))

    def guidance_fn(x_recon: torch.Tensor, x_t: torch.Tensor, t: int, s_: int, carry: Any):
        x_recon = x_recon.clone()
        for y, x, patch in pastes:
            h, w = patch.shape[1:3]
            region = x_recon[:, y : y + h, x : x + w, :]
            x_recon[:, y : y + h, x : x + w, :] = eta * patch + (1.0 - eta) * region
        return x_recon, carry, {}

    return guidance_fn
