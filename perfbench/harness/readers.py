"""What the metric readers (``perfbench/metrics/<metric>.py``) compute,
from a run's ``serve.Record``. A reader that finds nothing to read returns
None, and the harness leaves that metric out of the line; no share of a
peak is ever made up as 0."""
from __future__ import annotations

from typing import Optional

from perfbench.harness import roofline, stats


def goodput(rec) -> float:
    return stats.goodput(rec.requests, rec.seconds)


def tail_ms(rec) -> Optional[float]:
    return stats.tail_ms(rec.requests, 99.0)


def submit_lag_ms_p99(rec) -> Optional[float]:
    """How late the sender called ``Controller.on_request``: p99 over the
    window's requests of (call time - due time)."""
    return stats.percentile([(s.sent - s.due) * 1e3 for s in rec.requests],
                            99.0)


def slo_miss_pct(rec) -> Optional[float]:
    if not rec.requests:
        return None
    miss = sum(1 for s in rec.requests if s.status != "ok")
    return 100.0 * miss / len(rec.requests)


def batch_mean(rec) -> Optional[float]:
    if not rec.infers:
        return None
    return sum(i.batch for i in rec.infers) / len(rec.infers)


def pred_err_p99_pct(rec) -> Optional[float]:
    """p99 of |actual - predicted| / actual over the window's successful
    INFER ActionRecords."""
    errs = [100.0 * abs(a.actual - a.predicted) / a.actual
            for a in rec.actions
            if a.status == "SUCCESS" and a.predicted is not None
            and a.actual > 0]
    return stats.percentile(errs, 99.0)


def exec_ms_per_req(rec) -> Optional[float]:
    rows = sum(i.batch for i in rec.infers)
    if not rows:
        return None
    return 1e3 * sum(i.seconds for i in rec.infers) / rows


def idle_pct(rec) -> Optional[float]:
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def mfu_pct(rec) -> Optional[float]:
    """FLOPs of the requests the traced window's INFERs answered (not the
    padded bucket rows), over their window_s at the bf16 peak."""
    if rec.trace is None or not rec.traced_infers:
        return None
    rows = sum(i.batch for i in rec.traced_infers)
    flops = rec.deployment.flops_per_row() * rows
    return 100.0 * flops / (rec.trace.window_s * roofline.PEAK_BF16_FLOPS)


def kernel_roofline_pct(rec, kernel: str) -> Optional[float]:
    """The least time the card could take for the window's calls of
    ``kernel`` (each at its own bucket's shape), over the trace's device
    time of the kernels whose name holds ``kernel``. Where the trace holds
    fewer of them than the window launched, the device time is scaled up
    by the ratio, so that dropped records do not raise the share."""
    if rec.trace is None:
        return None
    work = [rec.deployment.kernel_work(i.bucket).get(kernel)
            for i in rec.traced_infers]
    work = [w for w in work if w is not None]
    seconds = rec.trace.device_seconds(kernel)
    traced = rec.trace.device_count(kernel)
    launched = sum(rec.deployment.port_kernels_per_infer().get(kernel, 0)
                   for _ in rec.traced_infers)
    if not work or not traced or not launched:
        return None
    least = sum(roofline.bound_s(b, f) for b, f in work)
    return 100.0 * least / (seconds * max(1.0, launched / traced))
