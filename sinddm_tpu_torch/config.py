"""Configuration of the port (part of ``sinddm_tpu/config.py``).

The dataclasses that sampling and training read, with the JAX package's
defaults, and ``MeshConfig``. ``TrainConfig``'s ``steps_per_chunk`` and
``fused_mode`` keep the JAX package's values and meanings: on the card a
chunk's steps are replays of one CUDA graph of a whole step
(``training/trainer.py``), where the JAX package runs them as one ``lax.scan``.
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
    # train steps a chunk: one loss fetch a chunk, and on the card each
    # step a replay of a captured CUDA graph. 0 disables the chunk path.
    steps_per_chunk: int = 100
    # 'grouped': equal per-scale sub-chunks at true shapes (deterministic
    #   uniform scale counts per chunk instead of the reference's i.i.d.
    #   multinomial draw, identical marginals: PARITY.md deviation 2);
    # 'padded': on-device multinomial scale choice over one padded canvas
    #   (exact reference scale distribution, ~2.5x more conv FLOPs);
    # fused_mode is ignored when steps_per_chunk == 0.
    fused_mode: str = "grouped"

    def __post_init__(self):
        if self.fused_mode not in ("grouped", "padded"):
            raise ValueError(f"fused_mode must be 'grouped' or 'padded', got {self.fused_mode!r}")


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Sampling-time knobs."""

    sample_batch_size: int = 16
    scale_mul: Tuple[float, float] = (1.0, 1.0)
    sample_t_list: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh layout: ('data', 'spatial') axes over the world's ranks, one rank
    a card (the JAX package's is over one process's devices).

    ``data * spatial`` ranks are used; (1, 1) means no mesh. Built by the
    CLI from ``--mesh_data`` / ``--mesh_spatial``.
    """

    data: int = 1
    spatial: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.spatial

    def build(self, world_size: Optional[int] = None):
        """Return a ('data', 'spatial') :class:`~sinddm_tpu_torch.parallel.mesh.Mesh`,
        or None for the 1x1 layout in a single process.

        Raises ValueError with an actionable message when the world is not
        exactly ``data * spatial`` ranks: a world larger than the mesh would
        leave ranks idle, a smaller one cannot hold it."""
        from sinddm_tpu_torch.parallel import distributed

        world = distributed.process_count() if world_size is None else int(world_size)
        if self.n_devices != world:
            raise ValueError(
                f"mesh data={self.data} x spatial={self.spatial} needs "
                f"{self.n_devices} ranks; the world has {world} (one process a card: "
                f"--num_processes {self.n_devices}, or torchrun --nproc-per-node)"
            )
        if self.n_devices <= 1:
            return None
        from sinddm_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(spatial=self.spatial, data=self.data)

    def validate_batch(self, batch_size: int, what: str) -> None:
        """Fail fast when a batch can't be laid out over the data axis, with
        the JAX package's message. The port's split would take an uneven
        batch, but the CLI keeps the JAX CLI's rule."""
        if self.data > 1 and batch_size % self.data != 0:
            raise ValueError(
                f"{what} ({batch_size}) must be divisible by "
                f"--mesh_data ({self.data})"
            )
