"""FLOPs of the requests answered in the traced window over window_s at the bf16 peak (model step)."""
from perfbench.harness.readers import mfu_pct as read  # noqa: F401
