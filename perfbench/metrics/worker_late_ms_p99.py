"""p99 of how long after its ``earliest`` the worker started each of the
window's successful INFERs (``t_start - earliest`` of the ActionRecords;
worker, core/worker.py). None where no record holds ``earliest``."""
from perfbench.harness.stats import percentile


def read(rec):
    return percentile([(a.t_start - a.earliest) * 1e3 for a in rec.actions
                       if a.status == "SUCCESS"
                       and getattr(a, "earliest", None) is not None], 99.0)
