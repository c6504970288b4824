"""INFER seconds TorchBackend returned in the window over the requests they carried (engine)."""
from perfbench.harness.readers import exec_ms_per_req as read  # noqa: F401
