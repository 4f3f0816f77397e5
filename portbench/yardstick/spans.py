"""The program's own spans placed on a traced unit's clock, and what each
covers of the trace's host ranges.

The program (``sinddm_tpu_torch/utils/profiling.py`` ``span``) records its
spans in memory while a ``torch.profiler`` session is active, each session
afresh, so after :func:`~portbench.yardstick.trace.profile` its list holds
the traced unit's spans (the last attempt's, where the harness traced more
than one). A program without them (an older tree) gives None here, and so
does every reader built on this. Two ways to place them:

* by name: where the trace holds the spans themselves as host ranges (a
  session that records host activity, as on the CPU), the program's i-th
  span of a name is the trace's i-th range of that name;
* by the clock calls: a session of device activity alone keeps no such
  range. The first span of the session made ``CLOCK_CALLS`` calls of
  ``CLOCK_CALL`` (``cudaStreamQuery``), each bracketed by two readings of
  the program's clock; the trace holds them among its CUDA calls. Of the
  runs of that many consecutive such calls, the one whose offsets agree
  best is taken, and of its calls the one with the least slack in its
  bracket gives the offset (to within half that slack).

The waits of the host are the trace's ranges in which it stands still for
the card or for the profiler: a full launch queue (CUPTI's
``Command_Buffer_Full``), the synchronizing CUDA calls, and CUPTI's own
buffer work. A span's host time is its duration less the parts the waits
cover.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PROGRAM = "sinddm_tpu_torch.utils.profiling"
PREFIX = "sinddm."
WAITS = ("Command_Buffer_Full", "Activity_Buffer_Request", "Buffer_Flush", "cudaDeviceSynchronize",
         "cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
TOP = 10


@dataclasses.dataclass
class Placed:
    """A program span on the trace's clock (us, as the trace's events)."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    attrs: dict
    start: float
    end: float
    counts_open: Optional[dict]
    counts_close: Optional[dict]

    @property
    def us(self) -> float:
        return self.end - self.start


def _plain(name: str) -> str:
    return name.replace(" ", "_")


def is_wait(name: str) -> bool:
    return _plain(name) in WAITS


def is_launch(name: str) -> bool:
    return name in LAUNCHES


def recorded():
    """The program's spans and clock marks from its loaded profiling module,
    or None where the program records none."""
    mod = sys.modules.get(PROGRAM)
    if mod is None or not hasattr(mod, "spans"):
        return None
    done = [r for r in mod.spans() if r.end_ns is not None]
    return (done, list(mod.clock_marks()), getattr(mod, "CLOCK_CALL", "cudaStreamQuery")) if done else None


def clock_offset(marks: Sequence[Tuple[int, int]], calls: Sequence[Tuple[float, float]]):
    """The program clock's ns at the trace's time 0, from the bracketed
    calls ``marks`` (ns before, ns after) and the trace's calls of that
    name ``calls`` (start, end in us, in order): ``(zero_ns, slack_us)``,
    the zero to within half the slack, or None where no run of
    consecutive calls fits."""
    n = len(marks)
    if n == 0 or len(calls) < n:
        return None
    best = None
    for j in range(len(calls) - n + 1):
        zeros = [(a + b) // 2 - round(500.0 * (s + e)) for (a, b), (s, e) in zip(marks, calls[j:j + n])]
        spread = max(zeros) - min(zeros)
        if best is None or spread < best[0]:
            best = (spread, j, zeros)
    _, j, zeros = best
    slack = [(b - a) / 1e3 - (e - s) for (a, b), (s, e) in zip(marks, calls[j:j + n])]
    i = min(range(n), key=lambda k: slack[k])
    return zeros[i], max(slack[i], 0.0)


def place(trace, log: Callable[[str], None]) -> Optional[List[Placed]]:
    """The program's spans of the traced unit on ``trace``'s clock, by name
    where the trace holds them, else by the clock calls; None where the
    program recorded none or they cannot be placed."""
    got = recorded()
    if got is None:
        return None
    done, marks, call = got
    named: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for s, e, n in trace.host:
        if n.startswith(PREFIX):
            named[n].append((s, e))
    if named:
        mine: Dict[str, list] = defaultdict(list)
        for r in done:
            mine[r.name].append(r)
        if {k: len(v) for k, v in mine.items()} != {k: len(v) for k, v in named.items()}:
            log(f"[spans] the program's spans {({k: len(v) for k, v in mine.items()})} are not the trace's "
                f"{({k: len(v) for k, v in named.items()})}: not placed")
            return None
        where = {}
        for name, rs in mine.items():
            for r, (s, e) in zip(rs, sorted(named[name])):
                where[r.id] = (s, e)
        log(f"[spans] {len(done)} program spans placed by name on the trace's host ranges")
    else:
        calls = sorted((s, e) for s, e, n in trace.host if n == call)
        fit = clock_offset(marks, calls)
        if fit is None:
            log(f"[spans] {len(done)} program spans, {len(marks)} clock marks, {len(calls)} {call} calls in the "
                f"trace: not placed")
            return None
        zero, slack = fit
        where = {r.id: ((r.start_ns - zero) / 1e3, (r.end_ns - zero) / 1e3) for r in done}
        log(f"[spans] {len(done)} program spans placed by {len(marks)} {call} calls: the program's clock reads "
            f"{zero:.0f} ns at the trace's 0, to within {slack / 2:.2f} us")
    return [Placed(r.name, r.id, r.parent, r.root, r.attrs, *where[r.id], r.counts_open, r.counts_close)
            for r in done]


def last_unit(placed: Sequence[Placed], root: str, name: str) -> Tuple[Optional[Placed], List[Placed]]:
    """The last span ``root`` (a walk, a chunk) and its descendants named
    ``name``, in order."""
    roots = [p for p in placed if p.name == root and p.parent is None]
    if not roots:
        return None, []
    top = roots[-1]
    return top, [p for p in placed if p.name == name and p.root == top.id]


def merged(ranges: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def host_ranges(trace, match: Callable[[str], bool]) -> List[Tuple[float, float]]:
    """The union of the trace's host ranges whose name ``match`` takes."""
    return merged([(s, e) for s, e, n in trace.host if match(n)])


def subtract(union: Sequence[Tuple[float, float]], cut: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``union`` less ``cut`` (both merged, sorted)."""
    out, j = [], 0
    for s, e in union:
        while j < len(cut) and cut[j][1] <= s:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < e:
            if cut[k][0] > s:
                out.append((s, cut[k][0]))
            s = max(s, cut[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def covered(start: float, end: float, union: Sequence[Tuple[float, float]]) -> float:
    """The us of ``union`` (merged, sorted) inside [start, end]."""
    i = max(bisect.bisect_right([s for s, _ in union], start) - 1, 0)
    total = 0.0
    while i < len(union) and union[i][0] < end:
        total += max(0.0, min(end, union[i][1]) - max(start, union[i][0]))
        i += 1
    return total


def host_us(spans: Sequence[Placed], waits: Sequence[Tuple[float, float]]) -> List[float]:
    """Each span's host us: its duration less what ``waits`` cover of it."""
    return [p.us - covered(p.start, p.end, waits) for p in spans]


def in_launches_us(spans: Sequence[Placed], trace, waits: Sequence[Tuple[float, float]]) -> float:
    """The us of ``spans`` (apart from one another) that the host spends
    inside launch calls, less the waits inside them."""
    own = subtract(host_ranges(trace, is_launch), waits)
    return sum(covered(p.start, p.end, own) for p in spans)


def count_inside(spans: Sequence[Placed], trace, match: Callable[[str], bool]) -> List[int]:
    """For each span, the trace's host ranges named as ``match`` takes that
    start inside it."""
    starts = sorted(s for s, _, n in trace.host if match(n))
    return [bisect.bisect_left(starts, p.end) - bisect.bisect_left(starts, p.start) for p in spans]


def innermost(placed: Sequence[Placed], starts: Sequence[float], t: float) -> Optional[Placed]:
    """The innermost span open at time ``t`` of ``placed`` (sorted by start,
    ``starts`` their starts): the latest-starting one not ended by then."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if placed[j].end >= t:
            return placed[j]
    return None


def idle_by_span(trace, placed: Sequence[Placed]) -> List[list]:
    """The device's idle time in the traced window, summed by the innermost
    program span, and the innermost CUDA call, at each gap's midpoint; the
    longest first."""
    from portbench.yardstick.trace import _host_at

    host = sorted(trace.host)
    starts = [h[0] for h in host]
    placed = sorted(placed, key=lambda p: p.start)
    span_starts = [p.start for p in placed]
    by: Dict[str, float] = defaultdict(float)
    edge = trace.window[0]
    for s, e in trace.busy_intervals() + [(trace.window[1], trace.window[1])]:
        if s > edge:
            mid = (edge + s) / 2
            p = innermost(placed, span_starts, mid)
            by[f"{p.name if p else 'outside any program span'} | {_host_at(host, starts, mid)}"] += (s - edge) / 1e6
        edge = max(edge, e)
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def summary(values: Sequence[float]) -> str:
    """Mean, median, p90, min and max of ``values``, and how many."""
    v = sorted(values)
    p90 = v[min(len(v) - 1, int(round(0.9 * (len(v) - 1))))]
    return (f"mean {statistics.fmean(v):.4f}, median {statistics.median(v):.4f}, p90 {p90:.4f}, "
            f"min {v[0]:.4f}, max {v[-1]:.4f} over {len(v)}")
