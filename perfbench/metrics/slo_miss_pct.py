"""Share of the window's requests that did not end ok (controller, core/controller.py)."""
from perfbench.harness.readers import slo_miss_pct as read  # noqa: F401
