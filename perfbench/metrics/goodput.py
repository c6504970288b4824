"""Requests sent in the window that ended ok, per second of the window (host clock)."""
from perfbench.harness.readers import goodput as read  # noqa: F401
