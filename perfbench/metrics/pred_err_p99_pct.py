"""p99 of |actual - predicted| / actual over the window's INFER records (predictor, core/predictor.py)."""
from perfbench.harness.readers import pred_err_p99_pct as read  # noqa: F401
