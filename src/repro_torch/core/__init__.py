"""Clockwork core: consolidated-choice model serving (copied from ``repro``).

  * actions.py    — LOAD/UNLOAD/INFER(+PREFILL/DECODE) with [earliest, latest]
  * clock.py      — virtual/real clocks + the discrete event loop
  * predictor.py  — rolling-p99 action latency profiles (per model, batch)
  * pagecache.py  — paged weight/KV memory accounting
  * worker.py     — predictable worker: per-resource executors, window
                    enforcement, reject-don't-queue straggler mitigation
  * scheduler.py  — the Appendix-B strategy-queue scheduler
  * controller.py — centralized controller: worker mirrors, SLO admission,
                    LOAD priorities, fault detection, elasticity
"""
from repro_torch.core.actions import (Action, ActionType, Request, Result,
                                      ResultStatus)  # noqa: F401
from repro_torch.core.clock import EventLoop, VirtualClock, RealClock  # noqa: F401
from repro_torch.core.controller import Controller  # noqa: F401
from repro_torch.core.pagecache import PageCache  # noqa: F401
from repro_torch.core.predictor import ActionProfiler  # noqa: F401
from repro_torch.core.scheduler import ClockworkScheduler  # noqa: F401
from repro_torch.core.worker import ModelDef, SimBackend, Worker  # noqa: F401
