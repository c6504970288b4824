"""Telemetry event records (§6 "telemetry" / Fig 2, Fig 9 inputs).

Two record types cover everything the paper's figures need:

* RequestSpan — the life of one request through the controller: arrival,
  queue admission, dispatch into an EXEC action, the (optional) cold-start
  LOAD that blocked it, on-device execution, and the response. Spans are
  opened by `Controller.on_request` and closed by `complete`/`reject`.
* ActionRecord — one controller<->worker action round-trip with the
  *predicted* duration (the estimate the scheduler committed to) next to
  the *actual* measured duration. Fig 9's over/under prediction-error CDFs
  are computed from these.

A third, lighter record type carries control-plane health samples:

* GaugeSample — one named scalar measurement at a point in time (e.g. the
  scheduler's per-tick wall latency `scheduler.tick_latency_s`). Gauges
  make control-plane overhead a first-class telemetry stream so perf
  regressions show up in `telemetry_report` and the bench harness.

Records are plain dataclasses with a `to_dict()` for JSONL export; they
deliberately import nothing from `repro.core` so the dependency points
core -> telemetry only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

NAN = float("nan")


@dataclasses.dataclass
class RequestSpan:
    """Per-request latency breakdown timestamps (all seconds, loop clock)."""
    request_id: int
    model_id: str
    arrival: float
    slo: float
    queued: float = NAN        # controller accepted it into the scheduler
    dispatched: float = NAN    # last EXEC action carrying it was sent
    load_start: float = NAN    # cold-start LOAD that unblocked it (if any)
    load_end: float = NAN
    exec_start: float = NAN    # on-device execution window
    exec_end: float = NAN
    response: float = NAN      # completion/rejection time
    status: Optional[str] = None   # "ok" | "timeout" | "rejected"
    worker_id: Optional[str] = None
    gpu_id: int = -1
    batch_size: int = 0
    attempts: int = 0          # dispatch count (>1 => requeued after reject)
    cold_start: bool = False
    # client-side spans only: the controller-clock [admission, completion]
    # interval echoed back in the RESPONSE. Both stamps share the remote
    # clock, so their difference is skew-free — `net_overhead` is the part
    # of the client-observed latency the controller never saw (network
    # legs + controller-side framing).
    remote_arrival: float = NAN
    remote_completion: float = NAN

    # ---------------------------------------------------------- breakdown
    @property
    def queue_delay(self) -> float:
        ref = self.dispatched if not math.isnan(self.dispatched) \
            else self.response
        return ref - self.arrival

    @property
    def exec_time(self) -> float:
        return self.exec_end - self.exec_start

    @property
    def total(self) -> float:
        return self.response - self.arrival

    @property
    def remote_total(self) -> float:
        """Controller-observed latency (admission -> completion)."""
        return self.remote_completion - self.remote_arrival

    @property
    def net_overhead(self) -> float:
        """Client-observed minus controller-observed latency."""
        return self.total - self.remote_total

    def to_dict(self) -> dict:
        # never-stamped phases export as null, keeping the JSONL strict
        return {k: (None if isinstance(v, float) and math.isnan(v) else v)
                for k, v in dataclasses.asdict(self).items()}

    @classmethod
    def from_dict(cls, d: dict) -> "RequestSpan":
        """Inverse of to_dict (wire decode / JSONL reload): null phase
        stamps come back as NaN."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for k in ("queued", "dispatched", "load_start", "load_end",
                  "exec_start", "exec_end", "response",
                  "remote_arrival", "remote_completion"):
            if kw.get(k) is None:
                kw[k] = NAN
        return cls(**kw)


@dataclasses.dataclass
class ActionRecord:
    """One action's predicted vs actual duration (+ worker-side stamps)."""
    action_id: int
    action_type: str
    model_id: str
    worker_id: str
    gpu_id: int
    batch_size: int
    status: str
    t_received: float          # worker received the action
    t_start: float             # execution began
    t_end: float               # result emitted
    actual: float              # measured on-device duration
    predicted: Optional[float] = None   # scheduler's committed estimate
    request_ids: Tuple[int, ...] = ()

    @property
    def error(self) -> Optional[float]:
        """predicted - actual; positive => over-prediction (actual faster)."""
        if self.predicted is None:
            return None
        return self.predicted - self.actual

    @property
    def worker_queue_delay(self) -> float:
        return self.t_start - self.t_received

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ActionRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["request_ids"] = tuple(kw.get("request_ids", ()))
        return cls(**kw)


@dataclasses.dataclass
class GaugeSample:
    """One named scalar sample (loop-clock timestamp, measured value)."""
    name: str
    t: float
    value: float

    def to_dict(self) -> dict:
        return {"name": self.name, "t": self.t, "value": self.value}

    @classmethod
    def from_dict(cls, d: dict) -> "GaugeSample":
        return cls(name=d["name"], t=d["t"], value=d["value"])
