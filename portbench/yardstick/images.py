"""The training image and its pyramid, made on the device from the seed.

The image is smooth seeded structure (a coarse normal field, bicubically
upsampled) under fine seeded noise, squashed into [-1, 1], at the
configuration's ``image_wh``. Each scale is its antialiased bicubic
downsample; each scale's coarser neighbour (the "recon" image SinDDM trains
against) is the bilinear upsample of the scale below. The program and the
reference are handed the same arrays.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def _resize(x: torch.Tensor, hw, mode: str, antialias: bool) -> torch.Tensor:
    kw = {} if mode == "nearest" else {"align_corners": False}
    return F.interpolate(x, size=tuple(hw), mode=mode, antialias=antialias, **kw)


def training_pyramid(seed: int, image_wh: Sequence[int], sizes_hw: Sequence[Tuple[int, int]], channels: int,
                     device) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(images, recons): [1, H, W, channels] float32 tensors a scale;
    ``recons[0]`` is ``images[0]``."""
    w, h = int(image_wh[0]), int(image_wh[1])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    coarse = torch.randn((1, channels, max(h // 16, 2), max(w // 16, 2)), generator=gen, device=device)
    fine = torch.randn((1, channels, h, w), generator=gen, device=device)
    img = torch.tanh(_resize(coarse, (h, w), "bicubic", False) + 0.25 * fine)
    images = [_resize(img, size, "bicubic", True).clamp(-1.0, 1.0) for size in sizes_hw]
    recons = [images[0]] + [_resize(images[i - 1], sizes_hw[i], "bilinear", False) for i in range(1, len(images))]
    nhwc = lambda x: x.permute(0, 2, 3, 1).contiguous()  # noqa: E731
    return [nhwc(x) for x in images], [nhwc(x) for x in recons]
