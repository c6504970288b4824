"""Percentiles and the request arithmetic of the end-to-end metrics. Plain
Python: every number here is reproducible from the records.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest value with at least ``q``% of
    the values at or below it. None for no values."""
    s = sorted(values)
    if not s:
        return None
    k = max(0, math.ceil(q / 100.0 * len(s)) - 1)
    return s[k]


def goodput(requests, seconds: float) -> float:
    """Requests sent in the window that ended ``ok``, per second of the
    window. Rejected, timed-out and unanswered requests count against it:
    they are in the window's requests and not ``ok``."""
    return sum(1 for r in requests if r.status == "ok") / seconds


def latency_ms(r) -> float:
    """Completion minus the time the request was due to be sent: a stall
    of the sender counts against every request due during it."""
    return (r.completion - r.due) * 1e3


def tail_ms(requests, q: float = 99.0) -> Optional[float]:
    """The ``q``th percentile of ``latency_ms`` over every request that got
    an answer (``ok`` or ``timeout``), one percentile of all of them."""
    return percentile([latency_ms(r) for r in requests
                       if r.status in ("ok", "timeout")], q)


def unanswered(requests) -> int:
    """Requests with no status once the drain has ended."""
    return sum(1 for r in requests if r.status is None)


def outstanding(requests, t: float) -> int:
    """Requests due by loop time ``t`` and not completed by then."""
    return sum(1 for r in requests if r.due <= t
               and (r.completion is None or r.completion > t))
