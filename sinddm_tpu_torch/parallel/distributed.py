"""The multi-process runtime on ``torch.distributed`` (port of ``sinddm_tpu/parallel/distributed.py``).

The JAX package runs one process a host, each over its local devices, and
joins them with ``jax.distributed.initialize``. PyTorch runs one process a
card: a JAX mesh over D x S devices becomes a world of D x S ranks here.

* :func:`initialize` joins the world before anything touches CUDA. It takes
  the coordinator's ``host:port``, the process count and this process's
  index from the flags, then from ``SINDDM_COORDINATOR`` /
  ``SINDDM_NUM_PROCESSES`` / ``SINDDM_PROCESS_ID``, then from torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` (PyTorch's counterpart of
  JAX's cluster detection). With none of these it does nothing and returns
  False: the single process stays as it was.
* The backend and the rank's device follow one rule (:func:`choose_backend`),
  printed when the world starts and never switched after a failure: gloo
  on the CPU when the caller asks for the CPU (the tests); NCCL when every
  local rank has a card of its own, rank on ``cuda:{local_rank}``; gloo
  when local ranks share cards (NCCL refuses two ranks on one card). The
  local rank and the local world are torchrun's ``LOCAL_RANK`` /
  ``LOCAL_WORLD_SIZE`` where set (:func:`local_layout`). With the three
  flags alone the layout is known only where it cannot be wrong: a
  loopback coordinator puts every rank on this host, and a world of no
  more ranks than this host has cards gives each rank the card of its
  index. A CUDA world that is neither stops and asks for the two variables
  (or torchrun), rather than guess a layout and run gloo where NCCL could.
* A collective that fails raises, and the run ends with a non-zero code.
* :func:`is_primary`: exactly one rank writes files (PNGs, JSON,
  checkpoints). The apps return whole values on every rank, so
  :func:`fetch` only copies to the host.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "is_initialized",
    "process_index",
    "process_count",
    "is_primary",
    "local_batch_slice",
    "fetch",
    "barrier",
    "shutdown",
    "choose_backend",
    "local_layout",
    "runtime",
    "build_kernels_once",
]

# how long a rank waits in a collective for the others before the run fails
TIMEOUT = datetime.timedelta(seconds=600)


class Runtime(NamedTuple):
    """What :func:`initialize` settled: the backend, this rank's device, its
    local rank and the number of ranks on its host."""

    backend: str
    device: torch.device
    local_rank: int
    local_world: int


_RUNTIME: Optional[Runtime] = None


def choose_backend(device_type: str, local_rank: int, local_world: int, n_cards: int):
    """The backend rule: ``(backend, device, why)`` of a rank.

    ``device_type`` is the caller's (``cpu`` or ``cuda``), ``n_cards`` the
    CUDA cards this host sees. Raises where the CUDA world has no card: a
    world asked for on the card never falls back to the CPU."""
    if device_type == "cpu":
        return "gloo", torch.device("cpu"), "the caller asked for the CPU"
    if device_type != "cuda":
        raise ValueError(f"a world runs on cpu or cuda, not {device_type!r}")
    if n_cards < 1:
        raise RuntimeError("a CUDA world needs a CUDA card on every host; pass --device cpu to run on the CPU")
    if n_cards >= local_world:
        return "nccl", torch.device("cuda", local_rank), f"every local rank has a card of its own ({n_cards} cards)"
    return ("gloo", torch.device("cuda", local_rank % n_cards),
            f"{local_world} local ranks share {n_cards} card(s); NCCL takes one rank a card")


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def _is_loopback(coordinator_address: Optional[str]) -> bool:
    host = (coordinator_address or "").rsplit(":", 1)[0].strip("[]")
    return host == "localhost" or host == "::1" or host.startswith("127.")


def local_layout(rank: int, world: int, device_type: str, n_cards: int,
                 coordinator_address: Optional[str] = None):
    """``(local_rank, local_world)`` of a rank: ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` where both are set (torchrun sets them). Else the
    rank's index and the world, where that cannot be wrong: on the CPU
    (gloo, no card to pick), with a loopback coordinator (every rank runs on
    this host), or with no more ranks than this host's cards (each rank's
    own card, whichever host it runs on). Raises otherwise."""
    local_rank, local_world = _env_int("LOCAL_RANK"), _env_int("LOCAL_WORLD_SIZE")
    if local_rank is not None and local_world is not None:
        return local_rank, local_world
    if device_type == "cpu" or _is_loopback(coordinator_address) or world <= n_cards:
        return rank, world
    raise ValueError(
        f"a world of {world} ranks on a host with {n_cards} card(s), joined at {coordinator_address}: "
        "cannot tell which ranks share this host. Set LOCAL_RANK and LOCAL_WORLD_SIZE on every rank "
        "(its index among this host's ranks, and their number), or start the world with torchrun")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> bool:
    """Join the world; returns True if this process is one rank of it.

    Idempotent. ``coordinator_address`` is ``host:port`` of rank 0's
    rendezvous; ``device`` is the caller's device type (``cuda`` or
    ``cpu``), which the backend rule reads. Must run before anything
    touches CUDA, so that an NCCL rank binds its own card first."""
    global _RUNTIME
    if _RUNTIME is not None:
        return True
    coordinator_address = coordinator_address or os.environ.get("SINDDM_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SINDDM_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SINDDM_PROCESS_ID")
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a world needs --coordinator, --num_processes and --process_id together "
                             f"(got {coordinator_address!r}, {num_processes!r}, {process_id!r})")
        init_method = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    elif os.environ.get("RANK") and os.environ.get("WORLD_SIZE") and os.environ.get("MASTER_ADDR"):
        init_method = "env://"  # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"process index {rank} is outside a world of {world}")
    device_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    local_rank, local_world = local_layout(rank, world, device_type, n_cards,
                                           coordinator_address or os.environ.get("MASTER_ADDR"))
    backend, rank_device, why = choose_backend(device_type, local_rank, local_world, n_cards)
    if backend == "nccl":
        torch.cuda.set_device(rank_device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, timeout=TIMEOUT)
    _RUNTIME = Runtime(backend, rank_device, local_rank, local_world)
    print(f"[world] rank {rank} of {world} on {socket.gethostname()}: backend {backend} ({why}), "
          f"device {rank_device}", flush=True)
    return True


def runtime() -> Optional[Runtime]:
    """The world's backend and this rank's device, or None outside a world."""
    return _RUNTIME


def is_initialized() -> bool:
    return _RUNTIME is not None


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the one rank that writes files."""
    return process_index() == 0


def local_batch_slice(global_batch: int, mesh) -> slice:
    """The rows of a [B, ...] global batch that this rank's coordinate on the
    mesh's ``data`` axis owns (:func:`~sinddm_tpu_torch.parallel.mesh.split_range`:
    no divisibility needed)."""
    from sinddm_tpu_torch.parallel.mesh import split_range

    lo, hi = split_range(global_batch, mesh.shape["data"], mesh.coords[0])
    return slice(lo, hi)


def fetch(x) -> np.ndarray:
    """The host value of an app's output. The apps return the whole value on
    every rank, so this is a copy to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def barrier() -> None:
    """Wait for every rank (a no-op outside a world)."""
    if is_initialized():
        if _RUNTIME.backend == "nccl":
            dist.barrier(device_ids=[_RUNTIME.device.index])
        else:
            dist.barrier()


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    global _RUNTIME
    if _RUNTIME is not None:
        dist.destroy_process_group()
        _RUNTIME = None


def build_kernels_once() -> None:
    """Build the CUDA kernels on local rank 0 while the other ranks wait, so
    that a host builds them once (each rank would otherwise build them
    too: the build is safe, but the work is done twice)."""
    if _RUNTIME is None or _RUNTIME.device.type != "cuda":
        return
    if _RUNTIME.local_rank == 0:
        from sinddm_tpu_torch.ops import _build

        _build.build()
    barrier()
