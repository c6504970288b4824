"""Centralized controller (§4.5, §5.3).

All decision-making lives here. The controller keeps, per worker:
  * memory state — a PageCache *mirror* updated optimistically on LOAD/UNLOAD
    submission and reconciled on results,
  * action profiles — rolling-window duration estimates (predictor.py),
  * pending actions — per-executor availability estimates.

It delegates policy to a pluggable Scheduler (scheduler.py implements the
paper's; baselines.py the reactive comparisons) — "this design concentrates
all choice in a single place, and enables different scheduler implementations
to be easily dropped in" (§5.3).

Fault tolerance (beyond the paper, §7 "future work"): heartbeats + missing-
result detection mark workers dead; their mirrors are dropped, outstanding
requests re-queued, and the LOAD-priority machinery re-replicates their
models elsewhere. Workers can be added/removed at runtime (elasticity).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional

from repro_torch.core.actions import (EXEC_TYPES, Action, ActionType, Request,
                                Result, ResultStatus)
from repro_torch.core.clock import EventLoop
from repro_torch.core.pagecache import PageCache
from repro_torch.core.predictor import ActionProfiler
from repro_torch.core.worker import ModelDef, Worker
from repro_torch.telemetry.recorder import Recorder
from repro_torch.telemetry.reports import summarize_run


@dataclasses.dataclass
class GpuMirror:
    pagecache: PageCache
    loading: set = dataclasses.field(default_factory=set)
    exec_free_at: float = 0.0
    load_free_at: float = 0.0
    # expected completion of in-flight actions by lane (action_id -> t);
    # replaces the per-result scan over every outstanding action
    pending_exec: Dict[int, float] = dataclasses.field(default_factory=dict)
    pending_load: Dict[int, float] = dataclasses.field(default_factory=dict)


class WorkerMirror:
    def __init__(self, worker: Worker):
        self.worker = worker
        self.worker_id = worker.worker_id
        self.alive = True
        self.gpus: List[GpuMirror] = [
            GpuMirror(pagecache=PageCache(
                pc.total_pages * pc.page_bytes, pc.page_bytes))
            for pc in worker.pagecaches
        ]
        self.outstanding: Dict[int, Action] = {}
        self.missed_results = 0
        # estimated one-way network delay to this worker (seconds). 0 for
        # in-process workers; for remote workers the runtime keeps it fresh
        # from heartbeat RTTs (§5 network-delay treatment) and the scheduler's
        # action windows widen by it in send_action.
        self.net_delay = 0.0

    def gpu_ids(self):
        return range(len(self.gpus))


class Controller:
    def __init__(self, loop: EventLoop, models: Dict[str, ModelDef],
                 scheduler, *, action_delay: float = 0.0005,
                 heartbeat_interval: float = 1.0,
                 heartbeat_timeout: float = 0.5,
                 result_grace: float = 0.050,
                 default_slo: float = 0.100,
                 missed_result_threshold: int = 2,
                 recorder: Optional[Recorder] = None):
        self.loop = loop
        self.models = models
        self.scheduler = scheduler
        self.action_delay = action_delay
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.result_grace = result_grace
        self.default_slo = default_slo
        self.missed_result_threshold = missed_result_threshold

        self.workers: Dict[str, WorkerMirror] = {}
        self.profiler = ActionProfiler()
        self.requests: Dict[int, Request] = {}
        # cluster-wide residency index over the mirrors: model -> set of
        # (worker_id, gpu_id); kept in sync by PageCache change hooks so the
        # scheduler's LOAD allocation never scans every GPU per model.
        # _gpu_ord ranks GPU keys in worker-registration order so index
        # lookups can be ordered exactly like a scan over the workers dict.
        self._residency: Dict[str, set] = {}
        self._res_ver: Dict[str, int] = {}   # bumped on any residency change
        self._gpu_ord: Dict[tuple, int] = {}
        self._gpu_ord_seq = 0
        self.on_response: Optional[Callable[[Request], None]] = None
        self.tick_interval = 0.001
        self._ticker_on = False
        # missed-result timer wheel: one armed sweep over a deadline heap
        # instead of one scheduled closure per action (heartbeat timeouts
        # ride the same mechanism via _arm_watch)
        self._watch_heap: List[tuple] = []    # (t, seq, kind, payload)
        self._watch_next = float("inf")       # earliest armed sweep time
        self._watch_seq = itertools.count()

        # telemetry
        self.recorder = recorder if recorder is not None else Recorder()
        self.completed: List[Request] = []
        self.stats = {"goodput": 0, "timeout": 0, "rejected": 0,
                      "cold_starts": 0, "actions": 0, "dead_workers": 0}

        scheduler.attach(self)

    # ------------------------------------------------------------ workers
    def add_worker(self, worker: Worker, profiles: Optional[dict] = None):
        """Register a worker; `profiles` seeds (type, model, batch)->secs."""
        m = WorkerMirror(worker)
        self.workers[worker.worker_id] = m
        worker.on_result = self.on_result
        for gid in m.gpu_ids():
            key = (worker.worker_id, gid)
            self._gpu_ord[key] = self._gpu_ord_seq
            self._gpu_ord_seq += 1
            m.gpus[gid].pagecache.on_resident_change = \
                self._residency_hook(key)
        if profiles:
            for (t, mid, b), d in profiles.items():
                self.profiler.seed(t, mid, b, d)
        self.scheduler.on_topology_change()
        return m

    def seed_from_store(self, store):
        """Seed action profiles from a persistent ProfileStore — the
        startup path that replaces per-process warmup re-measurement."""
        store.seed_profiler(self.profiler)
        # new seeds invalidate any estimates the scheduler has cached
        self.scheduler.on_topology_change()

    def remove_worker(self, worker_id: str):
        """Graceful removal (elastic scale-down)."""
        self._kill_mirror(worker_id, graceful=True)

    def _residency_hook(self, key):
        def hook(model_id: str, added: bool):
            self._res_ver[model_id] = self._res_ver.get(model_id, 0) + 1
            if added:
                s = self._residency.get(model_id)
                if s is None:
                    s = self._residency[model_id] = set()
                s.add(key)
            else:
                s = self._residency.get(model_id)
                if s is not None:
                    s.discard(key)
                    if not s:
                        del self._residency[model_id]
        return hook

    def residency_where(self, model_id: str):
        """GPU keys holding `model_id`, ordered exactly as a scan over the
        workers dict (registration order) would list them."""
        s = self._residency.get(model_id)
        if not s:
            return ()
        if len(s) == 1:
            return tuple(s)
        return sorted(s, key=self._gpu_ord.__getitem__)

    def _kill_mirror(self, worker_id: str, graceful: bool = False):
        m = self.workers.pop(worker_id, None)
        if m is None:
            return
        if not graceful:
            self.stats["dead_workers"] += 1
        # purge the dead mirror's GPUs from the residency index
        for gid in m.gpu_ids():
            g = m.gpus[gid]
            g.pagecache.on_resident_change = None
            key = (worker_id, gid)
            for mid in g.pagecache.resident:
                self._res_ver[mid] = self._res_ver.get(mid, 0) + 1
                s = self._residency.get(mid)
                if s is not None:
                    s.discard(key)
                    if not s:
                        del self._residency[mid]
            self._gpu_ord.pop(key, None)
        # re-queue outstanding exec requests if their deadline still allows
        for a in m.outstanding.values():
            for rid in a.request_ids:
                req = self.requests.get(rid)
                if req is not None and req.status is None:
                    self.scheduler.requeue(req)
        self.scheduler.on_topology_change()
        self.scheduler.tick()
        self._ensure_ticker()

    def worker_failed(self, worker_id: str):
        self._kill_mirror(worker_id, graceful=False)

    def start_heartbeats(self):
        def beat():
            for wid, m in list(self.workers.items()):
                ok = {"v": False}

                def pong(ok=ok):
                    ok["v"] = True

                m.worker.ping(pong)

                def check(wid=wid, ok=ok):
                    if not ok["v"]:
                        self.worker_failed(wid)

                self.watch_at(self.loop.now() + self.heartbeat_timeout,
                              check)
            self.loop.schedule_in(self.heartbeat_interval, beat)

        self.loop.schedule_in(self.heartbeat_interval, beat)

    def observe_net_delay(self, worker_id: str, rtt: float,
                          alpha: float = 0.2):
        """Fold a measured heartbeat round-trip into the worker's one-way
        network-delay estimate (EWMA). The runtime's ControllerServer calls
        this on every PONG; send_action widens expected starts and
        missed-result deadlines by the estimate."""
        m = self.workers.get(worker_id)
        if m is None or rtt < 0:
            return
        sample = rtt / 2.0
        if m.net_delay == 0.0:
            m.net_delay = sample
        else:
            m.net_delay = (1.0 - alpha) * m.net_delay + alpha * sample

    # ------------------------------------------------------- timer wheel
    # One armed `loop.schedule` sweeps a deadline heap, replacing the
    # per-action closure the missed-result detector used to schedule (and
    # the per-beat heartbeat-timeout closures, which share the wheel via
    # `watch_at`). Entries are (t, seq, kind, payload); seq keeps payloads
    # out of tuple comparison.
    _WATCH_ACTION, _WATCH_FN = 0, 1

    def _arm_watch(self, t: float):
        if t < self._watch_next:
            self._watch_next = t
            self.loop.schedule(t, self._watch_sweep)

    def watch_at(self, t: float, fn: Callable[[], None]):
        """Run `fn` once at time `t` via the shared timer-wheel sweep."""
        heapq.heappush(self._watch_heap,
                       (t, next(self._watch_seq), self._WATCH_FN, fn))
        self._arm_watch(t)

    def _watch_action_at(self, t: float, action_id: int, worker_id: str):
        heapq.heappush(self._watch_heap,
                       (t, next(self._watch_seq), self._WATCH_ACTION,
                        (action_id, worker_id)))
        self._arm_watch(t)

    def _watch_sweep(self):
        now = self.loop.now()
        if now + 1e-12 < self._watch_next:
            return  # superseded wakeup; an earlier re-arm already swept
        self._watch_next = float("inf")
        heap = self._watch_heap
        while heap and heap[0][0] <= now + 1e-12:
            _, _, kind, payload = heapq.heappop(heap)
            if kind == self._WATCH_ACTION:
                aid, wid = payload
                mm = self.workers.get(wid)
                if mm is not None and aid in mm.outstanding:
                    mm.missed_results += 1
                    if mm.missed_results >= self.missed_result_threshold:
                        self.worker_failed(wid)
            else:
                payload()
        if heap:
            self._arm_watch(heap[0][0])

    # ------------------------------------------------------------ requests
    def _has_pending(self) -> bool:
        hp = getattr(self.scheduler, "has_pending", None)
        if hp is not None:
            return hp()
        return any(self.scheduler.queues.values())

    def _ticker(self):
        """Periodic scheduler drive while work is pending (the event-driven
        stand-in for Clockwork's continuously-running scheduler thread)."""
        self.scheduler.tick()
        if self._has_pending():
            self.loop.schedule_in(self.tick_interval, self._ticker)
        else:
            self._ticker_on = False

    def _ensure_ticker(self):
        if not self._ticker_on:
            self._ticker_on = True
            self.loop.schedule_in(self.tick_interval, self._ticker)

    def on_request(self, req: Request):
        self.requests[req.id] = req
        self.recorder.span_open(req, queued=self.loop.now())
        self.scheduler.on_request(req)
        self.scheduler.tick()
        self._ensure_ticker()

    def reject(self, req: Request, when: Optional[float] = None):
        if req.status is not None:
            return
        req.status = "rejected"
        req.completion = when if when is not None else self.loop.now()
        self.stats["rejected"] += 1
        self.completed.append(req)
        self.recorder.span_close(req, req.completion)
        if self.on_response:
            self.on_response(req)

    def complete(self, req: Request, when: float):
        if req.status is not None:
            return
        req.completion = when
        if when <= req.deadline + 1e-9:
            req.status = "ok"
            self.stats["goodput"] += 1
        else:
            req.status = "timeout"
            self.stats["timeout"] += 1
        self.completed.append(req)
        self.recorder.span_close(req, when)
        if self.on_response:
            self.on_response(req)

    # ------------------------------------------------------------ actions
    def send_action(self, action: Action):
        m = self.workers.get(action.worker_id)
        if m is None:
            return
        now = self.loop.now()
        action.issued_at = now
        g = m.gpus[action.gpu_id]
        # one-way send estimate: controller-side dispatch overhead plus the
        # worker's estimated network delay (0 for in-process workers) — the
        # paper's §5 treatment of network delay in action windows
        send_est = self.action_delay + m.net_delay
        # pending-actions model: an executor starts this action no earlier
        # than when its already-submitted work completes
        if action.type == ActionType.LOAD:
            start = max(now + send_est, action.earliest,
                        g.load_free_at)
        else:
            start = max(now + send_est, action.earliest,
                        g.exec_free_at)
        action.expected_completion = start + action.expected_duration
        # optimistic mirror updates (reconciled on result)
        if action.type == ActionType.LOAD:
            model = self.models[action.model_id]
            g.pagecache.alloc(action.model_id,
                              model.pages(g.pagecache.page_bytes))
            g.loading.add(action.model_id)
            g.load_free_at = action.expected_completion
            g.pending_load[action.id] = action.expected_completion
        elif action.type == ActionType.UNLOAD:
            g.pagecache.free(action.model_id)
        elif action.type in EXEC_TYPES:
            g.pagecache.touch(action.model_id)
            g.exec_free_at = action.expected_completion
            g.pending_exec[action.id] = action.expected_completion
            self.recorder.span_dispatch(action.request_ids, now,
                                        action.worker_id, action.gpu_id,
                                        action.batch_size)
        m.outstanding[action.id] = action
        self.stats["actions"] += 1
        # the schedule_in below models only the controller-side dispatch;
        # for remote workers the transport itself adds the network leg
        self.loop.schedule_in(self.action_delay,
                              lambda: m.worker.receive(action))
        # missing-result failure detection via the shared timer wheel
        # (deadline covers both network legs: send_est out, net_delay back)
        if action.type != ActionType.UNLOAD:
            deadline = action.expected_completion + self.result_grace \
                + self.action_delay + send_est
            self._watch_action_at(max(deadline, action.latest
                                      + action.expected_duration
                                      + self.result_grace),
                                  action.id, action.worker_id)

    def on_result(self, result: Result):
        m = self.workers.get(result.worker_id)
        action = None
        if m is not None:
            action = m.outstanding.pop(result.action_id, None)
            m.missed_results = 0     # the worker is responsive again
            g = m.gpus[result.gpu_id]
            if result.action_type == ActionType.LOAD:
                g.loading.discard(result.model_id)
                if result.status is not ResultStatus.SUCCESS:
                    g.pagecache.free(result.model_id)  # reconcile mirror
                g.pending_load.pop(result.action_id, None)
                g.load_free_at = max(g.pending_load.values(),
                                     default=result.t_end)
            elif result.action_type in EXEC_TYPES:
                g.pending_exec.pop(result.action_id, None)
                g.exec_free_at = max(g.pending_exec.values(),
                                     default=result.t_end)
        # telemetry: predicted-vs-actual record with the action's dispatch
        # stamps and the backend's phases, + span phase stamps
        self.recorder.record_action(result, action)
        if result.status is ResultStatus.SUCCESS:
            if result.action_type in EXEC_TYPES:
                self.recorder.span_exec(result.request_ids, result.t_start,
                                        result.t_end)
            elif result.action_type == ActionType.LOAD:
                self.recorder.span_load(result.model_id, result.t_start,
                                        result.t_end)
        if result.status is ResultStatus.SUCCESS and result.duration > 0:
            self.profiler.observe(result.action_type.value, result.model_id,
                                  result.batch_size, result.duration)
        # request completion / re-queue
        for rid in result.request_ids:
            req = self.requests.get(rid)
            if req is None:
                continue
            if result.status is ResultStatus.SUCCESS:
                self.complete(req, result.t_end)
            else:
                self.scheduler.requeue(req)
        self.scheduler.on_result(result)
        self.scheduler.tick()
        if self._has_pending():
            self._ensure_ticker()

    # ------------------------------------------------------------ helpers
    def loaded_gpus(self, model_id: str):
        """(worker_id, gpu_id) pairs where model is resident or loading."""
        out = []
        for wid, m in self.workers.items():
            for gid in m.gpu_ids():
                g = m.gpus[gid]
                if g.pagecache.contains(model_id):
                    out.append((wid, gid))
        return out

    def summary(self) -> dict:
        lat = [r.completion - r.arrival for r in self.completed
               if r.status == "ok"]
        lat.sort()

        def pct(q):
            if not lat:
                return float("nan")
            i = min(len(lat) - 1, int(q * (len(lat) - 1)))
            return lat[i]

        return dict(self.stats, total=len(self.completed),
                    p50=pct(0.50), p99=pct(0.99), p999=pct(0.999),
                    max=lat[-1] if lat else float("nan"))

    def telemetry_report(self) -> dict:
        """Latency breakdown + prediction-error summary from the Recorder."""
        return summarize_run(self.recorder)
