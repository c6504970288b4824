"""p99 of how late the sender called Controller.on_request (event loop,
core/clock.py): lateness that SLO misses, and so goodput, follow."""
from perfbench.harness.readers import submit_lag_ms_p99 as read  # noqa: F401
