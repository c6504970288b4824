"""Busy time of the device over a traced window, from the profiler's event
list.

``busy_s`` is the length of the union of the device's activity intervals
(kernels, memcpy, memset) clipped to the window, and ``window_s`` the
window's length, both on the profiler's one clock: so 0 < busy_s <=
window_s holds by construction, and a trace with no device record in the
window is an error, never a 0. (``chip_smoke.py:_profile`` summed
``key_averages()``' kernel times instead: overlapping work counted twice,
and nothing bounded the sum by the window.)

The idle gaps are labelled with the benchmark's own host span open across
each gap's midpoint (the innermost one), recorded as ``record_function``
annotations by the serving stack's wrappers (``serve.py``).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "perfbench.window"
SPAN_PREFIX = "pb."
SHORT_GAP_NS = 10_000        # shorter idle gaps are counted together
NO_SPAN = "event_loop"       # the host outside every benchmark span


class TraceError(RuntimeError):
    """The trace cannot give a busy time (no window, no device record)."""


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int                       # kernels starting in the window
    records: int                       # device records in the window
    by_name: Dict[str, float]          # device seconds by name, clipped
    count_by_name: Dict[str, int]      # device records by name
    idle_by_span: Dict[str, float]     # idle seconds by host span

    def device_seconds(self, part: str) -> float:
        """Device seconds of the records whose name holds ``part``."""
        return sum(s for n, s in self.by_name.items() if part in n)

    def device_count(self, part: str) -> int:
        return sum(c for n, c in self.count_by_name.items() if part in n)


def union_length(intervals: Sequence[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def _merged(intervals, lo, hi) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label_gaps(busy, lo, hi, spans) -> Dict[str, float]:
    """Idle ns in [lo, hi] outside ``busy`` (merged), by the innermost span
    open at each gap's midpoint."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = defaultdict(float)
    prev = lo
    for s, e in list(busy) + [(hi, hi)]:
        gap = s - prev
        if gap > 0:
            if gap < SHORT_GAP_NS:
                out[f"gaps_under_{SHORT_GAP_NS // 1000}us"] += gap
            else:
                mid = prev + gap / 2
                label = NO_SPAN
                i = bisect.bisect_right(starts, mid) - 1
                while i >= 0:                  # the latest-opened cover
                    if spans[i][1] >= mid:
                        label = spans[i][2]
                        break
                    i -= 1
                out[label] += gap
        prev = max(prev, e)
    return dict(out)


def summarize(device, window: Tuple[float, float], spans=()) -> Trace:
    """``device``: (start_ns, end_ns, name, kind) records; ``window``:
    (start_ns, end_ns); ``spans``: (start_ns, end_ns, name) host spans.
    Raises TraceError when the window holds no device record."""
    lo, hi = window
    if not hi > lo:
        raise TraceError(f"empty window {window}")
    inside = [(s, e, n, k) for s, e, n, k in device if e > lo and s < hi]
    if not inside:
        raise TraceError(f"no device record in the traced window "
                         f"({len(device)} device records in the trace)")
    by_name: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for s, e, n, _ in inside:
        by_name[n] += (min(e, hi) - max(s, lo)) / 1e9
        count[n] += 1
    busy = _merged([(s, e) for s, e, _, _ in inside], lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    return Trace(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
                 kernels=sum(1 for s, _, _, k in inside
                             if k == "kernel" and s >= lo),
                 records=len(inside), by_name=dict(by_name),
                 count_by_name=dict(count),
                 idle_by_span={k: v / 1e9 for k, v in
                               _label_gaps(busy, lo, hi, spans).items()})


def _device_kind(name: str) -> str:
    low = name.lower()
    return ("gpu_memcpy" if "memcpy" in low else
            "gpu_memset" if "memset" in low else "kernel")


def read_profile(prof) -> Tuple[list, Optional[Tuple[int, int]], list]:
    """(device records, window, host spans) from a stopped
    ``torch.profiler.profile``'s raw kineto events (no FunctionEvent
    processing, which a window of many thousand kernels makes slow). A
    device record is an event on the CUDA device that is not an
    annotation (torch 2.11's events carry no activity kind)."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        on_card = e.device_type() == cuda
        if not e.is_user_annotation():
            if on_card:
                s, name = e.start_ns(), e.name()
                device.append((s, s + e.duration_ns(), name,
                               _device_kind(name)))
            continue
        if on_card:
            continue
        name = e.name()
        if name == WINDOW:
            s = e.start_ns()
            window = (s, s + e.duration_ns())
        elif name.startswith(SPAN_PREFIX):
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), name[len(SPAN_PREFIX):]))
    return device, window, spans
