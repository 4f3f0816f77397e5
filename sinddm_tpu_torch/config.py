"""Configuration for the sampling path (port of part of ``sinddm_tpu/config.py``).

Only the dataclasses that sampling reads; the training, guidance and mesh
configurations arrive with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Diffusion process knobs, with the reference defaults."""

    timesteps: int = 100
    scale_factor: float = 1.411
    loss_factor: float = 1.0
    loss_type: str = "l1"
    train_full_t: bool = True
    reblurring: bool = True
    sample_limited_t: bool = False
    omega: float = 0.0
    auto_scale: Optional[int] = 50000


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Sampling-time knobs."""

    sample_batch_size: int = 16
    scale_mul: Tuple[float, float] = (1.0, 1.0)
    sample_t_list: Optional[Tuple[int, ...]] = None
