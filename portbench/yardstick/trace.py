"""One unit of the window under ``torch.profiler``, reduced to what the
per-layer readers take.

The profiler records device activity only (CUPTI: the device's operations
and the CUDA calls that launched them), not every host operation, whose
recording slows the host enough to idle the card in a walk. The traced
window is the unit itself, timed on the host from before its first call
to the return of the ``synchronize`` that ends it, so host time before the
first launch counts as idle; on the trace's clock it ends where the last
operation ends. Device busy time is the union of the operations'
intervals (kernels, copies, fills) in that window, so overlapping
operations count once; user annotations are not operations. Each idle gap
is named by the innermost CUDA call running on the host at its midpoint.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

TOP = 10


@dataclasses.dataclass
class Trace:
    """A traced unit: device operations ``(start_us, end_us, name)`` inside
    the window, the window's bounds, and the host operations."""

    ops: List[Tuple[float, float, str]]
    window: Tuple[float, float]
    host: List[Tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for s, e, _ in sorted(self.ops):
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def seconds_where(self, match: Callable[[str], bool]) -> float:
        """Summed device seconds of the operations whose name ``match`` takes."""
        return sum(e - s for s, e, n in self.ops if match(n)) / 1e6

    def count_where(self, match: Callable[[str], bool]) -> int:
        return sum(1 for _, _, n in self.ops if match(n))

    def device_ops(self) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for s, e, n in self.ops:
            by[n[:160]] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The device's idle time, summed by the host operation running at
        each gap's midpoint, the longest first."""
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: Dict[str, float] = defaultdict(float)
        edge = self.window[0]
        for s, e in self.busy_intervals() + [(self.window[1], self.window[1])]:
            if s > edge:
                by[_host_at(host, starts, (edge + s) / 2)] += (s - edge) / 1e6
            edge = max(edge, e)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _host_at(host, starts, t: float, look_back: int = 400) -> str:
    """The innermost host operation covering time ``t``: the latest-starting
    one that has not ended by then."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if host[j][1] >= t:
            return host[j][2][:160]
    return "host, outside any CUDA call"


def profile(run: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``run`` and ``sync`` under ``torch.profiler`` (device activity;
    host activity where there is no card, as in the CPU tests), timing them
    on the host, and reduce the events."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    with torch_profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), window_s)


def reduce(events, window_s: float) -> Trace:
    """A :class:`Trace` from the profiler's function events and the window's
    host-timed length, its end put at the last operation's end."""
    import torch

    ops, host = [], []
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
    end = max((o[1] for o in ops), default=window_s * 1e6)
    return Trace(ops=ops, window=(end - window_s * 1e6, end), host=host)


def matcher(*parts: str) -> Callable[[str], bool]:
    """A name test: any of ``parts`` in the lower-cased name."""
    low = tuple(p.lower() for p in parts)
    return lambda name: any(p in name.lower() for p in low)
