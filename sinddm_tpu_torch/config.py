"""Configuration of the port (part of ``sinddm_tpu/config.py``).

The dataclasses that sampling and training read, with the JAX package's
defaults. ``TrainConfig`` leaves out ``steps_per_chunk`` and ``fused_mode``:
they fuse training steps into one XLA call, and the port runs one step a
call. The guidance and mesh configurations arrive with their slices.
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
class TrainConfig:
    """Training schedule, with the reference defaults."""

    train_batch_size: int = 32
    train_lr: float = 1e-3
    train_num_steps: int = 120001
    grad_accumulate: int = 1
    ema_decay: float = 0.995
    step_start_ema: int = 2000
    update_ema_every: int = 10
    save_and_sample_every: int = 10000
    avg_window: int = 100
    # milestones in steps (the CLI takes k-steps and multiplies by 1000)
    sched_milestones: Tuple[int, ...] = (20000, 40000, 70000, 80000, 90000, 110000)
    lr_gamma: float = 0.5


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Sampling-time knobs."""

    sample_batch_size: int = 16
    scale_mul: Tuple[float, float] = (1.0, 1.0)
    sample_t_list: Optional[Tuple[int, ...]] = None
