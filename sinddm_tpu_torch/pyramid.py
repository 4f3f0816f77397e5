"""Multi-scale image pyramid (port of ``sinddm_tpu/pyramid.py``).

* the image is capped at ``auto_scale`` pixels (50,000 by default);
* the scale-0 short side is chosen so the denoiser's receptive field
  covers ~40% of the scale-0 area (``AREA_SCALE_0 = 3110``), clamped to
  [42, 55];
* ``n_scales`` follows from the requested factor, and the exact factor is
  re-derived so the pyramid lands on the full size;
* each scale is a LANCZOS downsample of the original; each recon image is
  a BILINEAR upsample of scale i to scale i+1's size;
* ``rescale_losses[i] = ||down(i+1) - up(down(i))||_F / npix``, with the
  difference taken in **uint8 with wraparound** as the reference does.
  The quirk produces the published starting timesteps (e.g.
  (100, 52, 41, 31, 22) for balloons); ``exact_diff=True`` gives the true
  float difference.

Images are float32 HWC numpy arrays in [-1, 1]; sizes are (H, W). PIL is
imported only by the functions that read or write images, so the
geometry works without it.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

AREA_SCALE_0 = 3110
SCALE_0_DIM_MIN = 42
SCALE_0_DIM_MAX = 55
DEFAULT_AUTO_SCALE = 50000
DEFAULT_SCALE_FACTOR = 1.411


def _to_pm1(img) -> np.ndarray:
    """PIL image -> float32 HWC in [-1, 1]."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def _save_pm1(arr: np.ndarray, path: Path) -> None:
    from PIL import Image

    u8 = np.clip((arr + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(u8).save(path)


@dataclasses.dataclass(frozen=True)
class Pyramid:
    """Immutable pyramid of one training image (see module docstring)."""

    sizes_hw: Tuple[Tuple[int, int], ...]
    sizes_wh: Tuple[Tuple[int, int], ...]
    images: Tuple[np.ndarray, ...]
    recon_images: Tuple[np.ndarray, ...]
    rescale_losses: Tuple[float, ...]
    scale_factor: float
    n_scales: int

    def save(self, folder: str, filename: str) -> None:
        """Write scale_i/ and scale_i_recon/ dirs (the reference's layout)."""
        stem = filename.rsplit(".", 1)[0] + ".png"
        for i in range(self.n_scales):
            d = Path(folder) / f"scale_{i}"
            d.mkdir(parents=True, exist_ok=True)
            _save_pm1(self.images[i], d / stem)
            if i > 0:
                dr = Path(folder) / f"scale_{i}_recon"
                dr.mkdir(parents=True, exist_ok=True)
                _save_pm1(self.recon_images[i], dr / stem)


def compute_pyramid_geometry(
    image_size_wh: Tuple[int, int],
    scale_factor: float = DEFAULT_SCALE_FACTOR,
    auto_scale: Optional[int] = DEFAULT_AUTO_SCALE,
) -> Tuple[Tuple[int, int], List[Tuple[int, int]], float, int]:
    """Pure geometry: capped size, per-scale sizes (W, H), exact factor, n_scales."""
    image_size = tuple(image_size_wh)
    if auto_scale is not None:
        scaler = np.sqrt((image_size[0] * image_size[1]) / auto_scale)
        if scaler > 1:
            image_size = (int(image_size[0] / scaler), int(image_size[1] / scaler))

    s_dim = min(image_size[0], image_size[1])
    l_dim = max(image_size[0], image_size[1])
    scale_0_dim = int(round(np.sqrt(AREA_SCALE_0 * s_dim / l_dim)))
    scale_0_dim = min(max(scale_0_dim, SCALE_0_DIM_MIN), SCALE_0_DIM_MAX)
    min_val_image = min(image_size[0], image_size[1])
    n_scales = int(round((np.log(min_val_image / scale_0_dim)) / np.log(scale_factor)) + 1)
    exact_factor = float(np.exp((np.log(min_val_image / scale_0_dim)) / (n_scales - 1)))

    sizes_wh = []
    for i in range(n_scales):
        sizes_wh.append(
            (
                int(round(image_size[0] / np.power(exact_factor, n_scales - i - 1))),
                int(round(image_size[1] / np.power(exact_factor, n_scales - i - 1))),
            )
        )
    return image_size, sizes_wh, exact_factor, n_scales


def build_pyramid(
    image_path: str,
    scale_factor: float = DEFAULT_SCALE_FACTOR,
    image_size_wh: Optional[Tuple[int, int]] = None,
    auto_scale: Optional[int] = DEFAULT_AUTO_SCALE,
    exact_diff: bool = False,
    save_to: Optional[str] = None,
) -> Pyramid:
    """Build the multi-scale pyramid of a single training image."""
    from PIL import Image

    orig_image = Image.open(image_path).convert("RGB")
    size_wh = image_size_wh if image_size_wh is not None else orig_image.size
    _, sizes_wh, exact_factor, n_scales = compute_pyramid_geometry(
        size_wh, scale_factor=scale_factor, auto_scale=auto_scale
    )

    downscaled = [orig_image.resize(sizes_wh[i], Image.LANCZOS) for i in range(n_scales)]

    recons: List = [None]
    rescale_losses: List[float] = []
    for i in range(n_scales - 1):
        recon = downscaled[i].resize(sizes_wh[i + 1], Image.BILINEAR)
        recons.append(recon)
        if exact_diff:
            diff = np.asarray(downscaled[i + 1], dtype=np.float64) - np.asarray(
                recon, dtype=np.float64
            )
        else:
            # uint8 subtract with wraparound, as the reference computes it
            diff = np.subtract(np.asarray(downscaled[i + 1]), np.asarray(recon))
        rescale_losses.append(float(np.linalg.norm(diff) / np.asarray(recon).size))

    images = tuple(_to_pm1(im) for im in downscaled)
    recon_images = (images[0],) + tuple(_to_pm1(im) for im in recons[1:])
    sizes_hw = tuple((h, w) for (w, h) in sizes_wh)

    pyr = Pyramid(
        sizes_hw=sizes_hw,
        sizes_wh=tuple(tuple(s) for s in sizes_wh),
        images=images,
        recon_images=recon_images,
        rescale_losses=tuple(rescale_losses),
        scale_factor=exact_factor,
        n_scales=n_scales,
    )
    if save_to is not None:
        pyr.save(save_to, os.path.basename(image_path))
    return pyr


def load_external_image(
    path: str, auto_scale: Optional[int] = DEFAULT_AUTO_SCALE
) -> np.ndarray:
    """Load an external (image-to-image) input with the auto_scale cap.
    Returns float32 HWC in [-1, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    image_size = img.size
    if auto_scale is not None:
        scaler = np.sqrt((image_size[0] * image_size[1]) / auto_scale)
        if scaler > 1:
            image_size = (int(image_size[0] / scaler), int(image_size[1] / scaler))
            img = img.resize(image_size, Image.LANCZOS)
    return _to_pm1(img)
