"""Predictable worker (§4.4, §5.2).

One executor per (GPU/chip-slice, resource class): EXEC runs one inference at
a time (on TPU this is native — an XLA program owns the chip); LOAD owns the
host->HBM DMA path. Executors dequeue chronologically by `earliest`, wait
until `earliest`, and reject actions whose `latest` has passed — workers never
queue best-effort work, which is what stops stragglers from cascading.

Backends supply durations:
  * SimBackend — profile tables + configurable noise/spikes (C3), virtual time
  * callable backends (serving/engine.py) — actually execute JAX programs and
    return measured wall time (RealClock)
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.actions import (EXEC_TYPES, Action, ActionType, Result,
                                ResultStatus)
from repro_torch.core.clock import EventLoop
from repro_torch.core.pagecache import PAGE_BYTES, PageCache


@dataclasses.dataclass
class ModelDef:
    """Ground-truth model properties (the controller sees only telemetry)."""
    model_id: str
    weights_bytes: int
    exec_latency: Dict[Tuple[str, int], float]   # (action_type, batch) -> s
    input_bytes: int = 602_112                   # paper Table 1 default
    output_bytes: int = 4_096
    runner: Optional[Callable] = None            # real execution hook

    def pages(self, page_bytes: int = PAGE_BYTES) -> int:
        return PageCache.pages_for(self.weights_bytes, page_bytes)


class SimBackend:
    """Deterministic-latency execution with controllable jitter.

    noise: multiplicative gaussian sigma (DNN inference ~0.03% in the paper);
    spike_prob/spike_scale: rare external-factor delays (C3).
    """

    realtime = False

    def __init__(self, host_to_dev_bw: float = 25e9, load_fixed: float = 1e-3,
                 noise: float = 0.0003, spike_prob: float = 0.0,
                 spike_scale: float = 5.0, seed: int = 0):
        self.host_to_dev_bw = host_to_dev_bw
        self.load_fixed = load_fixed
        self.noise = noise
        self.spike_prob = spike_prob
        self.spike_scale = spike_scale
        self.rng = random.Random(seed)

    def _jitter(self, d: float) -> float:
        if self.noise:
            d *= max(0.0, self.rng.gauss(1.0, self.noise))
        if self.spike_prob and self.rng.random() < self.spike_prob:
            d *= self.spike_scale
        return d

    def load_duration(self, model: ModelDef) -> float:
        return self._jitter(self.load_fixed
                            + model.weights_bytes / self.host_to_dev_bw)

    def exec_duration(self, model: ModelDef, action: Action) -> float:
        key = (action.type.value, action.batch_size)
        if key not in model.exec_latency:
            # interpolate: nearest known batch scaled linearly
            known = sorted(b for (t, b) in model.exec_latency
                           if t == action.type.value)
            if not known:
                raise KeyError(key)
            b0 = min(known, key=lambda b: abs(b - action.batch_size))
            base = model.exec_latency[(action.type.value, b0)]
            d = base * action.batch_size / b0
        else:
            d = model.exec_latency[key]
        return self._jitter(d)


class Executor:
    """Serial action executor with [earliest, latest] window enforcement."""

    def __init__(self, worker: "Worker", gpu_id: int, name: str):
        self.worker = worker
        self.gpu_id = gpu_id
        self.name = name
        self.q = []                      # heap: (earliest, seq, action)
        self._seq = itertools.count()
        self.busy = False
        self.busy_until = 0.0
        self.total_busy = 0.0            # utilization telemetry

    def submit(self, action: Action):
        heapq.heappush(self.q, (action.earliest, next(self._seq), action))
        self._poll()

    def _poll(self):
        loop = self.worker.loop
        if self.busy or not self.worker.alive:
            return
        while self.q:
            earliest, _, action = self.q[0]
            now = loop.now()
            if now < earliest - 1e-9:
                wake = earliest
                heapq.heappop(self.q)
                heapq.heappush(self.q, (earliest, next(self._seq), action))
                loop.schedule(wake, self._poll)
                return
            heapq.heappop(self.q)
            if now > action.latest + 1e-9:
                self.worker.emit_result(action, ResultStatus.REJECTED_LATE,
                                        now, now, 0.0)
                continue
            status, duration = self.worker.perform(action)
            if status is not ResultStatus.SUCCESS:
                self.worker.emit_result(action, status, now, now, 0.0)
                continue
            self.busy = True
            end = loop.now() + (0.0 if self.worker.backend.realtime
                                else duration)
            self.busy_until = end
            self.total_busy += duration

            def _done(a=action, t0=now, d=duration):
                self.busy = False
                self.worker.finish(a)
                self.worker.emit_result(a, ResultStatus.SUCCESS, t0,
                                        self.worker.loop.now()
                                        if self.worker.backend.realtime
                                        else t0 + d, d)
                self._poll()

            loop.schedule(end, _done)
            return


class Worker:
    """One worker process managing `n_gpus` accelerator slices."""

    def __init__(self, worker_id: str, loop: EventLoop,
                 backend: SimBackend, models: Dict[str, ModelDef],
                 n_gpus: int = 1, device_memory_bytes: float = 32e9,
                 reserved_bytes: float = 1e9,
                 result_delay: float = 0.0005):
        self.worker_id = worker_id
        self.loop = loop
        self.backend = backend
        self.models = models
        self.alive = True
        self.result_delay = result_delay
        self.on_result: Optional[Callable[[Result], None]] = None
        self.pagecaches = [PageCache(int(device_memory_bytes
                                         - reserved_bytes))
                           for _ in range(n_gpus)]
        self.execs: Dict[Tuple[int, str], Executor] = {}
        for g in range(n_gpus):
            self.execs[(g, "EXEC")] = Executor(self, g, "EXEC")
            self.execs[(g, "LOAD")] = Executor(self, g, "LOAD")
        self.n_gpus = n_gpus

    # -------------------------------------------------- controller-facing
    def receive(self, action: Action):
        if not self.alive:
            return
        action.received_at = self.loop.now()
        lane = "LOAD" if action.type in (ActionType.LOAD,
                                         ActionType.UNLOAD) else "EXEC"
        self.execs[(action.gpu_id, lane)].submit(action)

    def ping(self, reply: Callable[[], None]):
        if self.alive:
            self.loop.schedule_in(self.result_delay, reply)

    def fail(self):
        """Crash: drop all queued work, stop emitting results."""
        self.alive = False

    # -------------------------------------------------- execution
    def perform(self, action: Action):
        """Returns (status, duration). Called at action start time."""
        pc = self.pagecaches[action.gpu_id]
        model = self.models.get(action.model_id)
        if model is None:
            return ResultStatus.ERROR_NOT_LOADED, 0.0
        if action.type == ActionType.LOAD:
            if pc.contains(action.model_id):
                return ResultStatus.SUCCESS, 1e-5
            if not pc.alloc(action.model_id, model.pages(pc.page_bytes)):
                return ResultStatus.ERROR_NO_PAGES, 0.0
            return ResultStatus.SUCCESS, self.backend.load_duration(model)
        if action.type == ActionType.UNLOAD:
            pc.free(action.model_id)
            return ResultStatus.SUCCESS, 1e-5
        # EXEC family
        if not pc.contains(action.model_id):
            return ResultStatus.ERROR_NOT_LOADED, 0.0
        pc.touch(action.model_id)
        return ResultStatus.SUCCESS, self.backend.exec_duration(model, action)

    def finish(self, action: Action):
        pass  # hook (real backends release IO buffers here)

    def emit_result(self, action: Action, status: ResultStatus,
                    t_start: float, t_end: float, duration: float):
        if not self.alive or self.on_result is None:
            return
        r = Result(action_id=action.id, action_type=action.type,
                   model_id=action.model_id, worker_id=self.worker_id,
                   gpu_id=action.gpu_id, status=status, t_start=t_start,
                   t_end=t_end, duration=duration,
                   batch_size=action.batch_size,
                   request_ids=action.request_ids,
                   t_received=action.received_at)
        self.loop.schedule_in(self.result_delay, lambda: self.on_result(r))

    # -------------------------------------------------- runtime descriptor
    def spec(self) -> dict:
        """Wire-serializable descriptor of this worker (memory geometry) —
        the payload a WorkerDaemon sends in its HELLO so the controller can
        build an exact PageCache mirror without sharing the process."""
        return {"worker_id": self.worker_id,
                "gpus": [{"total_pages": pc.total_pages,
                          "page_bytes": pc.page_bytes}
                         for pc in self.pagecaches]}

    # -------------------------------------------------- telemetry
    def utilization(self, horizon: float) -> Dict[str, float]:
        out = {}
        for (g, name), ex in self.execs.items():
            out[f"gpu{g}/{name}"] = ex.total_busy / max(horizon, 1e-9)
        return out
