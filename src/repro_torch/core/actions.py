"""Action / Result / Request types — the controller<->worker contract.

An Action is not an RPC: it communicates either a state change (LOAD/UNLOAD)
or a task with an explicit execution window. A worker MAY begin an action in
[earliest, latest]; outside the window the action is rejected, never executed
late (§4.4 — this is the straggler-mitigation mechanism).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional, Tuple

_action_ids = itertools.count()
_request_ids = itertools.count()


class ActionType(str, enum.Enum):
    LOAD = "LOAD"
    UNLOAD = "UNLOAD"
    INFER = "INFER"      # one-shot inference (CNNs) or a generic forward
    PREFILL = "PREFILL"  # LM serving: context ingestion (len-bucketed)
    DECODE = "DECODE"    # LM serving: one token step for a batch

EXEC_TYPES = (ActionType.INFER, ActionType.PREFILL, ActionType.DECODE)


class ResultStatus(str, enum.Enum):
    SUCCESS = "SUCCESS"
    REJECTED_LATE = "REJECTED_LATE"        # missed [earliest, latest] window
    ERROR_NOT_LOADED = "ERROR_NOT_LOADED"  # INFER without weights resident
    ERROR_NO_PAGES = "ERROR_NO_PAGES"      # LOAD with insufficient free pages
    ERROR_WORKER_DEAD = "ERROR_WORKER_DEAD"


@dataclasses.dataclass
class Request:
    model_id: str
    arrival: float
    slo: float                       # seconds; deadline = arrival + slo
    id: int = dataclasses.field(default_factory=lambda: next(_request_ids))
    batchable: bool = True
    # filled on completion:
    completion: Optional[float] = None
    status: Optional[str] = None     # "ok" | "timeout" | "rejected"

    @property
    def deadline(self) -> float:
        return self.arrival + self.slo


@dataclasses.dataclass
class Action:
    type: ActionType
    model_id: str
    worker_id: str
    gpu_id: int
    earliest: float
    latest: float
    expected_duration: float
    batch_size: int = 1
    request_ids: Tuple[int, ...] = ()
    id: int = dataclasses.field(default_factory=lambda: next(_action_ids))
    issued_at: float = 0.0
    expected_completion: float = 0.0
    received_at: float = 0.0         # stamped by the worker on receipt


@dataclasses.dataclass
class Result:
    action_id: int
    action_type: ActionType
    model_id: str
    worker_id: str
    gpu_id: int
    status: ResultStatus
    t_start: float
    t_end: float
    duration: float                  # on-device execution time
    batch_size: int = 1
    request_ids: Tuple[int, ...] = ()
    t_received: float = 0.0          # worker-side receipt stamp (telemetry)
