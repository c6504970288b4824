"""Telemetry reports: latency breakdowns, prediction-error summaries, and
Table-1-style profile tables.

These are the *single* aggregation path for the repo's figures:
`benchmarks/fig2_predictability.py` uses `latency_quantiles`/
`latency_summary`, `benchmarks/fig9_prediction_error.py` uses
`prediction_error_report` over Recorder action records, and
`serving/simulator.py` exposes `summarize_run`.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Sequence, Tuple


def quantile(xs: Sequence[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return float("nan")
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1)))]


def latency_quantiles(lats: Sequence[float],
                      qs: Sequence[float] = (0.5, 0.9, 0.99, 0.999, 1.0)
                      ) -> List[Tuple[float, float]]:
    return [(q, quantile(lats, q)) for q in qs]


def latency_summary(lats: Sequence[float]) -> dict:
    med = quantile(lats, 0.5)
    p99 = quantile(lats, 0.99)
    return {"count": len(lats), "median": med, "p99": p99,
            "p999": quantile(lats, 0.999),
            "max": max(lats) if lats else float("nan"),
            "p99_over_median": p99 / med if lats and med > 0
            else float("nan")}


# ------------------------------------------------------------------ spans
def latency_breakdown(spans: Iterable) -> dict:
    """Phase-by-phase latency stats over closed RequestSpans.

    Returns {"total": {...}, "queue": {...}, "exec": {...}} summaries over
    requests that completed ok, plus status/cold-start counts.
    """
    total, queue, execs = [], [], []
    statuses: Dict[str, int] = {}
    cold = 0
    for s in spans:
        statuses[s.status or "open"] = statuses.get(s.status or "open", 0) + 1
        if s.cold_start:
            cold += 1
        if s.status != "ok":
            continue
        total.append(s.total)
        if not math.isnan(s.queue_delay):
            queue.append(s.queue_delay)
        if not math.isnan(s.exec_time):
            execs.append(s.exec_time)
    return {"total": latency_summary(total),
            "queue": latency_summary(queue),
            "exec": latency_summary(execs),
            "statuses": statuses, "cold_starts": cold}


def client_breakdown(spans: Iterable) -> dict:
    """Client-side view over RemoteClient spans: client-observed latency,
    the controller-observed portion echoed back in each RESPONSE, and the
    network/framing overhead between the two (skew-free per request —
    see RequestSpan.net_overhead). This is the third-tier complement of
    `latency_breakdown`: the controller's report says how long serving
    took, this one says how long the *client waited*."""
    total, remote, net = [], [], []
    statuses: Dict[str, int] = {}
    for s in spans:
        statuses[s.status or "open"] = statuses.get(s.status or "open", 0) + 1
        if s.status != "ok":
            continue
        total.append(s.total)
        if not math.isnan(s.remote_total):
            remote.append(s.remote_total)
            net.append(s.net_overhead)
    return {"client_total": latency_summary(total),
            "controller_total": latency_summary(remote),
            "net_overhead": latency_summary(net),
            "statuses": statuses}


# ---------------------------------------------------------------- actions
def prediction_error_report(records: Iterable) -> dict:
    """Fig-9 over/under prediction-error stats from ActionRecords."""
    over, under = [], []
    for a in records:
        if a.status != "SUCCESS" or a.predicted is None or a.actual <= 0:
            continue
        err = a.predicted - a.actual
        (over if err >= 0 else under).append(abs(err))

    def stats(xs):
        return {"n": len(xs),
                "p99_us": (quantile(xs, 0.99) * 1e6) if xs else 0.0,
                "max_us": (max(xs) * 1e6) if xs else 0.0}

    return {"over": stats(over), "under": stats(under)}


# ----------------------------------------------------------------- gauges
def gauge_report(recorder) -> dict:
    """Summary stats per control-plane gauge (scheduler tick latency &c)."""
    out = {}
    for name, dq in getattr(recorder, "gauges", {}).items():
        xs = [g.value for g in dq]
        out[name] = {"n": len(xs),
                     "mean": (sum(xs) / len(xs)) if xs else float("nan"),
                     "p50": quantile(xs, 0.50), "p99": quantile(xs, 0.99),
                     "max": max(xs) if xs else float("nan")}
    return out


def summarize_run(recorder) -> dict:
    """One-call run summary: latency breakdown + prediction error +
    control-plane gauges."""
    return {"breakdown": latency_breakdown(recorder.iter_spans()),
            "prediction_error": prediction_error_report(
                recorder.iter_actions()),
            "gauges": gauge_report(recorder)}


# ------------------------------------------------------------------ jsonl
def load_jsonl(path: str) -> dict:
    """Reload a Recorder JSONL file (end-of-run `export_jsonl` or a
    `stream_to` file/rotation) into typed records, so offline analysis of
    a daemon's telemetry stream can reuse `latency_breakdown` /
    `prediction_error_report` unchanged."""
    from repro_torch.telemetry.events import (ActionRecord, GaugeSample,
                                        RequestSpan)
    out = {"spans": [], "actions": [], "gauges": []}
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            kind = d.pop("kind", None)
            if kind == "span":
                out["spans"].append(RequestSpan.from_dict(d))
            elif kind == "action":
                out["actions"].append(ActionRecord.from_dict(d))
            elif kind == "gauge":
                out["gauges"].append(GaugeSample.from_dict(d))
    return out


# ------------------------------------------------------------------ store
def profile_table(store, batches: Sequence[int] = (1, 2, 4, 8, 16)
                  ) -> List[str]:
    """Table-1-style report lines for a ProfileStore."""
    cols = "".join(f"  b{b}_ms" for b in batches)
    lines = [f"{'model':<24}  load_ms{cols}"]
    for mid in store.model_ids():
        load = store.get("LOAD", mid, 1)
        cells = [f"{load.median_s * 1e3:7.2f}" if load else f"{'—':>7}"]
        for b in batches:
            p = store.get("INFER", mid, b) or store.get("DECODE", mid, b)
            cells.append(f"{p.median_s * 1e3:6.2f}" if p else f"{'—':>6}")
        lines.append(f"{mid:<24}  " + " ".join(cells))
    return lines
