"""Requests carried per INFER in the window (scheduler, core/scheduler.py)."""
from perfbench.harness.readers import batch_mean as read  # noqa: F401
