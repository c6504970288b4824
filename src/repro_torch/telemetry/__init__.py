"""Telemetry & profiling (``repro.telemetry``: the records copied, the
profiler ported).

* events — RequestSpan / ActionRecord / GaugeSample dataclasses
* recorder — ring-buffer Recorder with JSONL export
* profile_store — persistent (action, model, batch) -> latency profiles
* reports — latency breakdowns, prediction-error, Table-1 tables
* profiler — offline profiler CLI (`python -m repro_torch.telemetry.profiler`)
"""
from repro_torch.telemetry.events import ActionRecord, GaugeSample, RequestSpan
from repro_torch.telemetry.profile_store import (LatencyProfile, ProfileStore,
                                                 STORE_VERSION)
from repro_torch.telemetry.recorder import Recorder
from repro_torch.telemetry.reports import (gauge_report, latency_breakdown,
                                           latency_quantiles, latency_summary,
                                           load_jsonl, prediction_error_report,
                                           profile_table, summarize_run)

__all__ = [
    "ActionRecord", "GaugeSample", "RequestSpan", "Recorder",
    "LatencyProfile", "ProfileStore", "STORE_VERSION",
    "gauge_report", "latency_breakdown", "latency_quantiles",
    "latency_summary", "load_jsonl", "prediction_error_report",
    "profile_table", "summarize_run",
]
