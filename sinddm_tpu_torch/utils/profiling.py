"""Tracing and timing hooks (port of ``sinddm_tpu/utils/profiling.py``).

* :func:`phase_timer`: a phase's wall time, logged after the device has
  finished its queued work (PyTorch returns before the card does);
* :func:`trace`: a ``torch.profiler`` trace of the host and, on a CUDA
  device, of the card's kernels, written where TensorBoard opens it; in a
  world of ranks, one trace a rank, under ``rank{r}/``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from sinddm_tpu_torch.parallel import distributed


def sync(device="cuda") -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, device="cuda", log: Optional[Callable[[str], None]] = None):
    """Log ``[phase] {name}: {seconds}s``, the wall time of the block up to
    the end of its device work.

    >>> with phase_timer("sample scale 3", device):
    ...     out = run()
    """
    log = log or print
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def trace(log_dir, device="cuda"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity on a CUDA device) and write a ``*.pt.trace.json`` under
    ``log_dir`` (TensorBoard's profiler plugin, or chrome://tracing), or
    under ``log_dir/rank{r}`` on rank r of a world."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if distributed.is_initialized():
        log_dir = Path(log_dir) / f"rank{distributed.process_index()}"

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
        sync(device)
