"""The reference's extra augmentation utilities as functions (port of
``sinddm_tpu/ops/augment_extra.py``).

The reference vendors five Text2LIVE transforms
(``text2live_util/aug_utils.py``) that no SinDDM code path imports; the JAX
package gives them as differentiable functions for completeness, on the
homographies of the live augmentation pipeline, and so does this port
(``ops/warp.py``). Each resamples into a fixed frame with the 4-tap gather
warp and fill 0.

Randomness: where the JAX package takes a key, each function here takes its
draws as arguments (the uniform numbers in their ranges, so a test can pass
the JAX package's), or draws the missing ones from ``generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sinddm_tpu_torch.ops.warp import crop_resize_matrix, perspective_matrix, warp_homography


def _draw(value, generator: Optional[torch.Generator], shape=(), lo: float = 0.0, hi: float = 1.0,
          device=None) -> torch.Tensor:
    """``value`` as float32 on ``device``, or U(lo, hi) of ``shape`` from ``generator``."""
    if value is None:
        value = torch.rand(shape, generator=generator) * (hi - lo) + lo
    return torch.as_tensor(value, dtype=torch.float32).to(device)


def random_scale(img: torch.Tensor, out_hw: Tuple[int, int], min_scale: float = 0.8, max_scale: float = 1.2,
                 *, scale=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Rescale [H, W, C] by s ~ U(min_scale, max_scale) (``scale``) into an
    ``out_hw`` frame, anchored at the top-left (a fixed output shape, where
    the torchvision original returns the scaled size)."""
    h, w = img.shape[0], img.shape[1]
    s = _draw(scale, generator, lo=min_scale, hi=max_scale, device=img.device)
    m = crop_resize_matrix(torch.zeros_like(s), torch.zeros_like(s), h / s, w / s, out_hw)
    return warp_homography(img, m, out_hw, fill=0.0)


def random_size_crop(img: torch.Tensor, out_hw: Tuple[int, int], min_cover: float = 0.5, *, cover=None,
                     uy=None, ux=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A random crop of side ``cover`` ~ U(min_cover, 1) of the image's, at
    offsets ``uy`` / ``ux`` ~ U(0, 1) of the room left, resampled to ``out_hw``."""
    h, w = img.shape[0], img.shape[1]
    f = _draw(cover, generator, lo=min_cover, hi=1.0, device=img.device)
    ch, cw = h * f, w * f
    y0 = _draw(uy, generator, device=img.device) * (h - ch)
    x0 = _draw(ux, generator, device=img.device) * (w - cw)
    return warp_homography(img, crop_resize_matrix(y0, x0, ch, cw, out_hw), out_hw, fill=0.0)


def divisible_crop(img: torch.Tensor, d: int) -> torch.Tensor:
    """Centre-crop H and W (the last axes but channels) down to multiples of d."""
    h, w = img.shape[-3], img.shape[-2]
    nh, nw = (h // d) * d, (w // d) * d
    y0, x0 = (h - nh) // 2, (w - nw) // 2
    return img[..., y0 : y0 + nh, x0 : x0 + nw, :]


def to_tensor_safe(img) -> torch.Tensor:
    """A PIL image, array or tensor -> float32 [H, W, C] in [0, 1] (divided
    by 255 when its values reach past 1.5; a channel axis added to [H, W])."""
    arr = img.float() if isinstance(img, torch.Tensor) else torch.as_tensor(np.asarray(img), dtype=torch.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def borderless_random_perspective(img: torch.Tensor, distortion_scale: float = 0.5, *, ux=None, uy=None,
                                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A perspective warp whose corners move only inward (by ``ux`` / ``uy``
    ~ U(0, 1)^4 of ``distortion_scale`` half the side), so no fill border
    appears; the inner quad is resampled onto the full [H, W] frame."""
    h, w = img.shape[0], img.shape[1]
    dx = _draw(ux, generator, (4,), device=img.device) * (distortion_scale * (w // 2))
    dy = _draw(uy, generator, (4,), device=img.device) * (distortion_scale * (h // 2))
    corners = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], dtype=torch.float32, device=img.device)
    signs = torch.tensor([[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=torch.float32, device=img.device)
    inner = corners + signs * torch.stack([dx, dy], dim=-1)
    # the inner quad onto the full frame: the out->in map takes corners to inner
    return warp_homography(img, perspective_matrix(inner, corners), (h, w), fill=0.0)
