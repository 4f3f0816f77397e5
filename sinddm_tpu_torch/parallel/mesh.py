"""The ('data', 'spatial') mesh over the world's ranks, and the split denoiser call
(port of ``sinddm_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
GSPMD partition the jitted walk: the batch over ``data``, the image's H
over ``spatial``, with the halo exchanges the convolutions need. The port
has no compiler to partition for it, so it keeps the state whole and splits
the work (**replicated state, split work**):

* every rank holds the whole [B, H, W, 3] state and draws every random
  number whole, from the same generator: a world makes exactly the single
  process's draws;
* the denoiser, nearly all of a step, runs split (:func:`split_model_fn`):
  a rank takes its batch rows (``B / data``) and its image rows (``H /
  spatial``) plus a halo of :data:`~sinddm_tpu_torch.models.denoiser.RECEPTIVE_RADIUS`
  rows each side, crops the halo from the output, and one collective puts
  the whole output back on every rank. No halo exchange is needed, since
  every rank holds the whole input, and the kernels run unchanged on each
  slab;
* the pointwise rest of a step runs whole on every rank.

Ranks lie on the mesh data-major, as ``make_mesh`` lays devices: rank =
``d * spatial + s``. Rows split as evenly as they go (:func:`split_range`):
neither B nor H has to divide. Every gather is an all-reduce (a sum) of a
zeroed whole buffer into which each rank wrote its block: exact, since
every element has one writer, and the one collective both backends take
for CUDA tensors (gloo's CUDA set is broadcast and all-reduce).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def split_range(n: int, parts: int, i: int) -> Tuple[int, int]:
    """``[lo, hi)`` of part ``i`` of ``n`` rows in ``parts`` parts: the first
    ``n % parts`` parts take one row more."""
    base, extra = divmod(int(n), int(parts))
    lo = i * base + min(i, extra)
    return lo, lo + base + (1 if i < extra else 0)


def halo_slab(n: int, parts: int, i: int, halo: int) -> Tuple[int, int, int, int]:
    """Part ``i`` of ``n`` rows and the slab it reads: ``(lo, hi, in_lo,
    in_hi)``, the owned rows ``[lo, hi)`` and ``halo`` rows more on each
    side, cut at the edges of the image (where the convolutions' zero
    padding is the image's own)."""
    lo, hi = split_range(n, parts, i)
    return lo, hi, max(0, lo - halo), min(n, hi + halo)


class Mesh:
    """A ``data x spatial`` grid of the world's ranks, data-major.

    ``coords`` is this rank's ``(d, s)``; ``group(axis)`` the process group
    of the ranks that differ from this one along ``axis`` only (None when
    that axis has one rank): the ``data`` group gathers batch rows, the
    ``spatial`` group image rows. Build it with :func:`make_mesh`."""

    axis_names = (DATA_AXIS, SPATIAL_AXIS)

    def __init__(self, data: int, spatial: int, rank: int, groups: dict):
        self.shape = {DATA_AXIS: int(data), SPATIAL_AXIS: int(spatial)}
        self.rank = int(rank)
        self.coords = divmod(self.rank, int(spatial))
        self._groups = groups

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[SPATIAL_AXIS]

    def group(self, *axes: str):
        """The process group over ``axes`` (both: the world), or None when it
        holds this rank alone."""
        ranks = 1
        for a in set(axes):
            ranks *= self.shape[a]
        if ranks == 1:
            return None
        if ranks == self.size:
            return dist.group.WORLD
        return self._groups[axes[0]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {dict(zip(self.axis_names, self.coords))})"


def make_mesh(spatial: int = 1, data: Optional[int] = None) -> Mesh:
    """Build the ``(data, spatial)`` mesh over the whole world (every rank
    calls it, in the same order: it creates process groups). ``data``
    defaults to world / spatial; raises ``ValueError`` when the world is not
    ``data * spatial`` ranks."""
    if not dist.is_initialized():
        raise ValueError("a mesh needs a world: call parallel.distributed.initialize first")
    world = dist.get_world_size()
    if world % spatial != 0:
        raise ValueError(f"{world} ranks not divisible by spatial={spatial}")
    data = world // spatial if data is None else int(data)
    if data * spatial != world:
        raise ValueError(f"mesh data={data} x spatial={spatial} needs {data * spatial} ranks; the world has {world}")
    rank = dist.get_rank()
    d_me, s_me = divmod(rank, spatial)
    groups = {}
    # every rank creates every group, in one order (torch.distributed's rule)
    for s in range(spatial):
        g = dist.new_group([d * spatial + s for d in range(data)]) if 1 < data < world else None
        if s == s_me:
            groups[DATA_AXIS] = g
    for d in range(data):
        g = dist.new_group([d * spatial + s for s in range(spatial)]) if 1 < spatial < world else None
        if d == d_me:
            groups[SPATIAL_AXIS] = g
    return Mesh(data, spatial, rank, groups)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How an app splits a [B, H, W, C] batch over a mesh: ``spec`` names the
    mesh axis of each dimension (None: whole on every rank), as JAX's
    ``PartitionSpec`` does. Build it with :func:`batch_sharding` or
    :func:`replicated_sharding`."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def axis(self, dim: int) -> Optional[str]:
        return self.spec[dim] if dim < len(self.spec) else None

    def parts(self, dim: int) -> Tuple[int, int]:
        """(number of parts, this rank's part) of dimension ``dim``."""
        a = self.axis(dim)
        if a is None:
            return 1, 0
        return self.mesh.shape[a], self.mesh.coords[self.mesh.axis_names.index(a)]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[B, H, W, C] batches: B over ``data``, H over ``spatial``."""
    return NamedSharding(mesh, (DATA_AXIS, SPATIAL_AXIS, None, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replicate a module's parameters and buffers over the mesh: broadcast
    from rank 0, in place. Returns the module."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0)
    return module


def require_named_sharding(sharding) -> Optional[NamedSharding]:
    """Validate an app's ``sharding`` argument: a :class:`NamedSharding` or
    None. Anything else (a JAX sharding, a mesh) raises ``TypeError`` up
    front rather than deep inside a walk."""
    if sharding is None:
        return None
    if not isinstance(sharding, NamedSharding):
        raise TypeError(
            f"sharding must be a NamedSharding over a ('{DATA_AXIS}', '{SPATIAL_AXIS}') mesh "
            f"(see batch_sharding); got {type(sharding).__name__}")
    return sharding


def gather_block(block: torch.Tensor, full_shape: Sequence[int], index: Tuple[slice, ...], group) -> torch.Tensor:
    """Put every rank's ``block`` (its ``index`` of a tensor of ``full_shape``)
    together on every rank of ``group``: an all-reduce of a zeroed whole
    buffer. The ranks' indices must tile the whole tensor, each element
    once. ``group`` None: ``block`` is the whole tensor already."""
    if group is None:
        return block
    out = block.new_zeros(tuple(full_shape))
    out[index] = block
    dist.all_reduce(out, group=group)
    return out


def split_model_fn(model_fn, sharding: NamedSharding):
    """``model_fn(x, t, s)`` split over the mesh: each rank runs it on its
    batch rows (dimension 0 over ``sharding``'s axis) and its image rows
    (dimension 1) with the denoiser's receptive radius of rows more on each
    side (:data:`~sinddm_tpu_torch.models.denoiser.RECEPTIVE_RADIUS`: each
    owned output row then sees exactly the input rows it sees in the whole
    call), crops the halo, and the whole [B, H, W, C] output is gathered on
    every rank. The per-sample ``t`` and ``s`` vectors are sliced with the
    rows."""
    from sinddm_tpu_torch.models.denoiser import RECEPTIVE_RADIUS

    axes = [a for a in (sharding.axis(0), sharding.axis(1)) if a is not None]
    group = sharding.mesh.group(*axes) if axes else None
    if group is None:
        return model_fn

    def fn(x, t_vec, s_vec):
        b, h = x.shape[:2]
        b0, b1 = split_range(b, *sharding.parts(0))
        h0, h1, in0, in1 = halo_slab(h, *sharding.parts(1), RECEPTIVE_RADIUS)

        def rows(v):
            return v[b0:b1] if isinstance(v, torch.Tensor) and v.ndim == 1 and v.shape[0] == b else v

        if b1 > b0 and h1 > h0:
            eps = model_fn(x[b0:b1, in0:in1].contiguous(), rows(t_vec), rows(s_vec))[:, h0 - in0 : h1 - in0]
        else:  # more ranks than rows: this rank owns nothing
            eps = x.new_zeros((b1 - b0, h1 - h0) + tuple(x.shape[2:]))
        return gather_block(eps, (b, h) + tuple(eps.shape[2:]), (slice(b0, b1), slice(h0, h1)), group)

    return fn
