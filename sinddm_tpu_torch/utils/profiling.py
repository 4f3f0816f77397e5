"""Tracing hooks (port of ``sinddm_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` trace of the host and, on a CUDA
  device, of the card's kernels, written where TensorBoard opens it; in a
  world of ranks, one trace a rank, under ``rank{r}/``.
* :func:`span`: the program's own spans (``sinddm.walk``, ``sinddm.scale``,
  ``sinddm.step``, ``sinddm.denoiser``, ``sinddm.guidance``,
  ``sinddm.train_chunk``, ``sinddm.train_step``, ``sinddm.trainer_init``
  and its phases, ``sinddm.graph_capture``). They are recorded only while a
  ``torch.profiler`` session is active, :func:`trace`'s or any other: in
  memory (:func:`spans`, the last session's) and as
  ``torch.profiler.record_function`` ranges, so they appear in the
  profiler's own trace too. Outside a session a span costs one flag check.

A span never synchronizes, reads a tensor or launches device work. Its times
are ``time.time_ns()``, the clock the profiler's events are converted to.
A session that records device activity alone keeps no ``record_function``
range, so the first span of each session on a CUDA process also makes
:data:`CLOCK_CALLS` calls of ``cudaStreamQuery``, each bracketed by two
readings of that clock (:func:`clock_marks`), inside a range of the
recorder's own (:data:`SETUP`): a reader finds those calls among the
trace's CUDA calls and places the spans on the trace's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from sinddm_tpu_torch.parallel import distributed

CLOCK_CALL = "cudaStreamQuery"  # the CUDA runtime call that places the spans on a trace's clock
CLOCK_CALLS = 4  # bracketed calls a session; the tightest bracket places best
SETUP = "profiling.spans_setup"  # the range of the recorder's own set-up in each session


def sync(device="cuda") -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir, device="cuda"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity on a CUDA device) and write a ``*.pt.trace.json`` under
    ``log_dir`` (TensorBoard's profiler plugin, or chrome://tracing), or
    under ``log_dir/rank{r}`` on rank r of a world. The program's spans are
    among its ranges."""
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


@dataclasses.dataclass
class Span:
    """One recorded span: ``id`` is its index in :func:`spans`, ``parent``
    the innermost span open when it opened (None at the top), ``root`` the
    id of its outermost ancestor (its own at the top); times in
    ``time.time_ns()``; ``counts_open`` / ``counts_close`` the span's
    counters read as it opened and closed (None without counters)."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    attrs: dict
    start_ns: int
    end_ns: Optional[int] = None
    counts_open: Optional[Dict[str, int]] = None
    counts_close: Optional[Dict[str, int]] = None


_spans: List[Span] = []  # the last session's spans, in the order they opened
_open: List[Span] = []  # the spans open now, innermost last
_marks: List[Tuple[int, int]] = []  # this session's clock calls: (ns before, ns after)
_session = 0  # bumped as each profiler session starts
_list_session = -1  # the session _spans belongs to


def spans() -> List[Span]:
    """The spans of the last profiler session, in the order they opened."""
    return list(_spans)


def clock_marks() -> List[Tuple[int, int]]:
    """The last session's :data:`CLOCK_CALL` calls, each as the
    ``time.time_ns()`` readings just before and just after it, in order;
    empty where the session began before CUDA was initialized."""
    return list(_marks)


def _on_profiler_start(_start=getattr(_autograd_profiler, "_run_on_profiler_start", None)) -> None:
    global _session
    _start()
    _session += 1


# torch calls this as each profiler session starts, before it records
if hasattr(_autograd_profiler, "_run_on_profiler_start"):
    _autograd_profiler._run_on_profiler_start = _on_profiler_start


def _begin_session() -> None:
    """Start the list afresh for the session running now, and place it on
    the session's clock where CUDA is in use and no stream is capturing.
    This set-up is a range of its own, ``SETUP``, which also pays for the
    session's first range (up to ~1.5 ms the first time in a process)."""
    global _list_session
    _list_session = _session
    _spans.clear()
    _open.clear()
    _marks.clear()
    with torch.profiler.record_function(SETUP):
        if torch.cuda.is_available() and torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            query = torch.cuda.current_stream().query
            query()  # the session's first CUDA call pays for the profiler's buffers
            for _ in range(CLOCK_CALLS):
                before = time.time_ns()
                query()
                _marks.append((before, time.time_ns()))


class _Recording:
    """A span being recorded; see :func:`span`."""

    __slots__ = ("name", "counters", "attrs", "rec", "rf")

    def __init__(self, name: str, counters, attrs: dict):
        self.name, self.counters, self.attrs = name, counters, attrs

    def __enter__(self):
        if _list_session != _session:
            _begin_session()
        parent = _open[-1] if _open else None
        i = len(_spans)
        rec = Span(self.name, i, None if parent is None else parent.id, i if parent is None else parent.root,
                   self.attrs, 0, counts_open=None if self.counters is None else self.counters())
        _spans.append(rec)
        _open.append(rec)
        self.rec, self.rf = rec, torch.profiler.record_function(self.name)
        # the profiler stamps a range early in entering it and late in leaving it
        rec.start_ns = time.time_ns()
        self.rf.__enter__()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.counters is not None:
            rec.counts_close = self.counters()
        if _open and _open[-1] is rec:
            _open.pop()
        self.rf.__exit__(*exc)
        rec.end_ns = time.time_ns()
        return False


_NULL = contextlib.nullcontext()


def span(name: str, counters: Optional[Callable[[], Dict[str, int]]] = None, **attrs):
    """A context manager that records the block as a span ``name`` with
    ``attrs`` while a ``torch.profiler`` session is active (``with span(...)
    as rec``: rec is its :class:`Span`), and else returns one shared null
    context (rec is None). ``counters()``, when given, is read as the span
    opens and as it closes."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Recording(name, counters, attrs)

