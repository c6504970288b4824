"""latency_p99_ms's arithmetic where the tail is host-paced or past capacity: recorded, not judged."""
from perfbench.harness.readers import tail_ms as read  # noqa: F401
