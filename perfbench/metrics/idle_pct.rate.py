"""100 x (1 - busy_s / window_s) of the traced window (device)."""
from perfbench.harness.readers import idle_pct as read  # noqa: F401
