"""Image resizing with the reference's interpolation semantics
(port of ``sinddm_tpu/ops/resize.py``).

* bilinear, ``align_corners=False``, no antialias: half-pixel-centre
  linear sampling, which equals ``jax.image.resize(method="linear",
  antialias=False)`` both up and down;
* nearest with torch's legacy floor index map ``floor(dst * in / out)``.

Both take NHWC (or HWC) tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) images to (H, W)."""
    if x.ndim == 3:
        return resize_bilinear(x[None], size_hw)[0]
    if x.ndim != 4:
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(x.shape)}")
    h, w = int(size_hw[0]), int(size_hw[1])
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def resize_nearest(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC (or HWC) with torch's floor index map."""
    h, w = int(size_hw[0]), int(size_hw[1])
    in_h, in_w = x.shape[-3], x.shape[-2]
    # float32 index arithmetic, as the JAX package computes it
    rows = torch.floor(torch.arange(h, dtype=torch.float32) * (in_h / h)).long()
    cols = torch.floor(torch.arange(w, dtype=torch.float32) * (in_w / w)).long()
    rows = rows.clamp(0, in_h - 1).to(x.device)
    cols = cols.clamp(0, in_w - 1).to(x.device)
    return x.index_select(-3, rows).index_select(-2, cols)
