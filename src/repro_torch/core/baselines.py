"""Reactive baseline schedulers for the Fig-5 comparison.

These run on the *same* controller/worker substrate as Clockwork, differing
only in policy — i.e. we compare scheduling disciplines, not implementations:

* ClipperScheduler — best-effort, work-conserving: requests dispatched
  immediately round-robin, per-model AIMD adaptive batching toward the SLO as
  an *average* target, on-demand LOAD, actions never rejected
  (latest = +inf). Tail latency propagates via queueing (§3 "stragglers").

* InfaasScheduler — reactive model-variant selection: picks a batch-size
  variant per model from recent load, rebalances to the least-loaded GPU on a
  monitoring interval; SLOs are coarse thresholds for variant switching.
"""
from __future__ import annotations

import collections
import itertools
from typing import Deque, Dict

from repro_torch.core.actions import Action, ActionType, Request, Result, ResultStatus

INF = float("inf")


class _ReactiveBase:
    def __init__(self, *, action_type: ActionType = ActionType.INFER,
                 horizon: float = 0.005):
        self.action_type = action_type
        self.horizon = horizon
        self.c = None
        self.queues: Dict[str, Deque[Request]] = collections.defaultdict(
            collections.deque)
        self._rr = itertools.count()
        self._in_tick = False

    def attach(self, controller):
        self.c = controller

    def on_topology_change(self):
        pass

    def on_request(self, req: Request):
        self.queues[req.model_id].append(req)

    def requeue(self, req: Request):
        if req.status is None:
            self.queues[req.model_id].appendleft(req)

    def on_result(self, result: Result):
        pass

    def _gpus(self):
        out = []
        for wid, m in self.c.workers.items():
            for gid in m.gpu_ids():
                out.append((wid, gid, m.gpus[gid]))
        return out

    def _ensure_loaded(self, mid: str, wid: str, gid: int, g, now: float):
        if g.pagecache.contains(mid):
            return True
        model = self.c.models[mid]
        pages = model.pages(g.pagecache.page_bytes)
        guard = 0
        while g.pagecache.free_pages < pages and guard < 64:
            guard += 1
            victim = g.pagecache.lru_candidate(exclude=g.loading)
            if victim is None:
                return False
            self.c.send_action(Action(
                type=ActionType.UNLOAD, model_id=victim, worker_id=wid,
                gpu_id=gid, earliest=now, latest=INF,
                expected_duration=1e-5))
        self.c.send_action(Action(
            type=ActionType.LOAD, model_id=mid, worker_id=wid, gpu_id=gid,
            earliest=now, latest=INF,
            expected_duration=1e-3 + model.weights_bytes / 25e9))
        return False  # not yet resident; exec will follow next tick

    def _send_exec(self, mid: str, reqs, wid: str, gid: int, now: float):
        est = self.c.profiler.estimate_or(self.action_type.value, mid,
                                          len(reqs), 0.005 * len(reqs))
        self.c.send_action(Action(
            type=self.action_type, model_id=mid, worker_id=wid, gpu_id=gid,
            earliest=now, latest=INF, expected_duration=est,
            batch_size=len(reqs), request_ids=tuple(r.id for r in reqs)))


class ClipperScheduler(_ReactiveBase):
    def __init__(self, **kw):
        super().__init__(**kw)
        # multiplicative backoff factor per model (AIMD around the profile)
        self.scale: Dict[str, float] = collections.defaultdict(lambda: 1.0)

    def _batch_for(self, mid: str, slo: float) -> int:
        """Clipper's adaptive batching: largest batch whose (profiled) batch
        latency fits the SLO, AIMD-adjusted by observed violations."""
        allowed = slo * 0.7 * self.scale[mid]
        best = 1
        for b in (1, 2, 4, 8, 16):
            est = self.c.profiler.estimate_or(self.action_type.value, mid, b,
                                              0.005 * b)
            if est <= allowed:
                best = b
        return best

    def on_result(self, result: Result):
        if result.status is not ResultStatus.SUCCESS or not result.request_ids:
            return
        mid = result.model_id
        for rid in result.request_ids:
            req = self.c.requests.get(rid)
            if req is None or req.completion is None:
                continue
            lat = req.completion - req.arrival
            if lat > req.slo:
                self.scale[mid] = max(0.1, self.scale[mid] * 0.9)
            else:
                self.scale[mid] = min(1.0, self.scale[mid] + 0.02)

    def tick(self):
        if self.c is None or self._in_tick:
            return
        self._in_tick = True
        try:
            now = self.c.loop.now()
            gpus = self._gpus()
            if not gpus:
                return
            for mid, q in self.queues.items():
                while q:
                    wid, gid, g = gpus[next(self._rr) % len(gpus)]
                    if g.exec_free_at > now + self.horizon:
                        full = all(gg.exec_free_at > now + self.horizon
                                   for _, _, gg in gpus)
                        if full:
                            return
                        continue
                    if not self._ensure_loaded(mid, wid, gid, g, now):
                        break
                    b = self._batch_for(mid, q[0].slo)
                    take = min(b, len(q))
                    reqs = [q.popleft() for _ in range(take)]
                    self._send_exec(mid, reqs, wid, gid, now)
        finally:
            self._in_tick = False


class InfaasScheduler(_ReactiveBase):
    """Variant selection by recent arrival rate; least-loaded placement."""

    def __init__(self, monitor_interval: float = 0.010, **kw):
        super().__init__(**kw)
        self.monitor_interval = monitor_interval
        self.rate_ewma: Dict[str, float] = collections.defaultdict(float)
        self._last_arrival: Dict[str, float] = {}

    def on_request(self, req: Request):
        super().on_request(req)
        t = self._last_arrival.get(req.model_id)
        now = req.arrival
        if t is not None and now > t:
            inst = 1.0 / (now - t)
            self.rate_ewma[req.model_id] = (0.9 * self.rate_ewma[req.model_id]
                                            + 0.1 * inst)
        self._last_arrival[req.model_id] = now

    def _variant(self, mid: str, slo: float) -> int:
        # largest batch variant whose exec time fits half the SLO; only
        # upgrade past batch-4 when the arrival rate sustains it
        best = 1
        for b in (1, 2, 4, 8, 16):
            est = self.c.profiler.estimate_or(self.action_type.value, mid, b,
                                              0.005 * b)
            if est <= slo * 0.5 and (b <= 4 or
                                     self.rate_ewma[mid] * est >= b * 0.25):
                best = b
        return best

    def tick(self):
        if self.c is None or self._in_tick:
            return
        self._in_tick = True
        try:
            now = self.c.loop.now()
            gpus = self._gpus()
            if not gpus:
                return
            for mid, q in self.queues.items():
                while q:
                    # least-loaded gpu
                    wid, gid, g = min(gpus, key=lambda x: x[2].exec_free_at)
                    if g.exec_free_at > now + self.horizon:
                        return
                    if not self._ensure_loaded(mid, wid, gid, g, now):
                        break
                    b = self._variant(mid, q[0].slo)
                    take = min(b, len(q))
                    reqs = [q.popleft() for _ in range(take)]
                    self._send_exec(mid, reqs, wid, gid, now)
        finally:
            self._in_tick = False
