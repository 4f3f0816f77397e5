"""Host-side image IO (port of ``sinddm_tpu/ops/image_io.py``).

Images are float arrays in [0, 1] (callers denormalise from [-1, 1]),
arranged into an ``nrow``-column grid with 2 px padding, torchvision's
default layout. Tensors are moved to the host here. PIL is imported only
when a file is written.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().float().cpu().numpy()
    return np.asarray(img)


def to_uint8(img01) -> np.ndarray:
    return np.clip(_host(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def make_grid(batch01, nrow: int = 4, padding: int = 2) -> np.ndarray:
    """[B, H, W, C] in [0,1] -> grid [H', W', C] in [0,1]."""
    batch01 = _host(batch01)
    b, h, w, c = batch01.shape
    ncol = min(nrow, b)
    nrows = (b + ncol - 1) // ncol
    grid = np.zeros(
        (padding + nrows * (h + padding), padding + ncol * (w + padding), c),
        dtype=batch01.dtype,
    )
    for i in range(b):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = batch01[i]
    return grid


def save_image(img01, path: Union[str, Path], nrow: int = 4) -> None:
    """Save [B,H,W,C] (as a grid) or [H,W,C] image in [0,1] to PNG."""
    from PIL import Image

    img01 = _host(img01)
    if img01.ndim == 4:
        img01 = make_grid(img01, nrow=nrow)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(to_uint8(img01)).save(path)


def save_interm_frames(frames, out_dir: Union[str, Path], *, s: int, t_min: int = 0) -> None:
    """Dump a per-step frame stack in the reference's ``save_interm`` layout:
    ``frames`` [n_steps, B, H, W, 3] in [-1, 1], t descending (the sampler's
    order), written as ``output_t-{t:03}_s-{s}.png`` grids under ``out_dir``,
    t counting down to ``t_min``."""
    frames = _host(frames)
    n_steps = frames.shape[0]
    out_dir = Path(out_dir)
    for j in range(n_steps):
        save_image((frames[j] + 1.0) * 0.5, out_dir / f"output_t-{t_min + n_steps - 1 - j:03d}_s-{s}.png")
