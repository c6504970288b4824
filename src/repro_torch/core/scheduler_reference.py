"""Pre-optimization Clockwork scheduler, frozen verbatim (PR 2).

This is the O(models x batches) implementation that rebuilds the full
strategy list after every scheduled action. It is kept for two reasons:

  * the decision-equivalence regression test runs it side by side with the
    incremental `repro.core.scheduler.ClockworkScheduler` on seeded
    workloads and asserts identical goodput/timeout/reject counts, and
  * `benchmarks/bench_scheduler.py --compare` measures the speedup of the
    incremental implementation against it (BENCH_scheduler.json).

Do not optimize this file; its value is being the unoptimized baseline.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.actions import (Action, ActionType, Request, Result,
                                ResultStatus)

DEFAULT_BATCHES = (1, 2, 4, 8, 16)


class ReferenceClockworkScheduler:
    def __init__(self, *, schedule_ahead: float = 0.005,
                 batch_sizes=DEFAULT_BATCHES,
                 action_type: ActionType = ActionType.INFER,
                 load_window: float = 0.250,
                 max_loads_in_flight_per_gpu: int = 2):
        self.schedule_ahead = schedule_ahead
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.action_type = action_type
        self.load_window = load_window
        self.max_loads = max_loads_in_flight_per_gpu
        self.c: Optional["Controller"] = None
        self.queues: Dict[str, Deque[Request]] = collections.defaultdict(
            collections.deque)
        self._in_tick = False

    # ---------------------------------------------------------- interface
    def attach(self, controller):
        self.c = controller

    def on_topology_change(self):
        pass

    def on_request(self, req: Request):
        self.queues[req.model_id].append(req)

    def requeue(self, req: Request):
        if req.status is not None:
            return
        q = self.queues[req.model_id]
        q.appendleft(req)

    def on_result(self, result: Result):
        pass

    # ---------------------------------------------------------- estimates
    def _est(self, model_id: str, b: int) -> Optional[float]:
        return self.c.profiler.estimate(self.action_type.value, model_id, b)

    def _est_or_scale(self, model_id: str, b: int) -> float:
        e = self._est(model_id, b)
        if e is not None:
            return e
        e1 = self.c.profiler.estimate_or(self.action_type.value, model_id, 1,
                                         0.005)
        return e1 * b

    def _load_est(self, model_id: str) -> float:
        e = self.c.profiler.estimate("LOAD", model_id, 1)
        if e is not None:
            return e
        mdl = self.c.models[model_id]
        return 1e-3 + mdl.weights_bytes / 25e9

    # ---------------------------------------------------------- main loop
    def tick(self):
        if self.c is None or self._in_tick:
            return
        self._in_tick = True
        try:
            now = self.c.loop.now()
            self._drop_hopeless(now)
            self._schedule_exec(now)
            self._schedule_loads(now)
        finally:
            self._in_tick = False

    # Drop requests that can no longer meet their SLO anywhere (§4.1: cancel
    # before fruitless work).
    def _drop_hopeless(self, now: float):
        for mid, q in self.queues.items():
            while q:
                changed = False
                for i, r in enumerate(q):
                    if r.status is not None:
                        del q[i]
                        changed = True
                        break
                    if r.deadline - self._est_or_scale(mid, 1) < now:
                        self.c.reject(r)
                        del q[i]
                        changed = True
                        break
                if not changed:
                    break

    def _strategies(self, now: float) -> List[Tuple[float, str, int]]:
        """(required_start, model, batch) sorted; best per (model, batch)."""
        out = []
        for mid, q in self.queues.items():
            if not q:
                continue
            n = len(q)
            for b in self.batch_sizes:
                if b > n and b != self.batch_sizes[0]:
                    continue
                eff_b = min(b, n)
                exec_t = self._est_or_scale(mid, b)
                dl = min(q[i].deadline for i in range(eff_b))
                out.append((dl - exec_t, mid, b))
        out.sort()
        return out

    def _schedule_exec(self, now: float):
        strategies = self._strategies(now)
        if not strategies:
            return
        for wid, m in self.c.workers.items():
            for gid in m.gpu_ids():
                g = m.gpus[gid]
                while g.exec_free_at < now + self.schedule_ahead:
                    picked = self._pick_strategy(strategies, now, g)
                    if picked is None:
                        break
                    req_start, mid, b = picked
                    q = self.queues[mid]
                    take = min(b, len(q))
                    reqs = [q.popleft() for _ in range(take)]
                    exec_t = self._est_or_scale(mid, take)
                    dl = min(r.deadline for r in reqs)
                    start_at = max(now, g.exec_free_at)
                    a = Action(type=self.action_type, model_id=mid,
                               worker_id=wid, gpu_id=gid,
                               earliest=now, latest=max(now, dl - exec_t),
                               expected_duration=exec_t, batch_size=take,
                               request_ids=tuple(r.id for r in reqs))
                    self.c.send_action(a)
                    strategies = self._strategies(now)
                    if not strategies:
                        return

    def _pick_strategy(self, strategies, now: float, g) -> Optional[tuple]:
        avail = max(now, g.exec_free_at)
        seen_models = set()
        for (req_start, mid, b) in strategies:
            q = self.queues.get(mid)
            if not q:
                continue
            if not (g.pagecache.contains(mid) and mid not in g.loading):
                continue  # not resident on this executor's GPU
            if mid in seen_models:
                continue  # a larger batch for this model was already viable
            if b > len(q) and b != self.batch_sizes[0]:
                continue
            exec_t = self._est_or_scale(mid, min(b, len(q)))
            dl = min(q[i].deadline for i in range(min(b, len(q))))
            if avail + exec_t > dl:
                # cannot finish in time on this executor
                seen_models.add(mid)
                continue
            # prefer larger batch: check if a larger batch is also feasible
            return (req_start, mid, b)
        return None

    # ---------------------------------------------------------- LOAD/UNLOAD
    def _demands(self) -> Dict[str, float]:
        d = {}
        for mid, q in self.queues.items():
            if q:
                d[mid] = sum(self._est_or_scale(mid, 1) for _ in range(len(q)))
        return d

    def _schedule_loads(self, now: float):
        demands = self._demands()
        if not demands:
            return
        # GPU loads l_g: demand allocated to each gpu
        gpu_keys = []
        for wid, m in self.c.workers.items():
            for gid in m.gpu_ids():
                gpu_keys.append((wid, gid))
        if not gpu_keys:
            return
        loads = {k: 1e-6 for k in gpu_keys}
        allocs: Dict[str, Dict[tuple, float]] = {}
        for mid, dm in demands.items():
            where = [k for k in gpu_keys
                     if self.c.workers[k[0]].gpus[k[1]].pagecache.contains(mid)]
            if not where:
                continue
            inv = {k: 1.0 for k in where}
            tot = sum(inv.values())
            allocs[mid] = {k: dm * inv[k] / tot for k in where}
            for k, v in allocs[mid].items():
                loads[k] += v
        # priorities
        capacity = self.schedule_ahead * 50  # exec-seconds per horizon unit
        prios = []
        for mid, dm in demands.items():
            a = allocs.get(mid, {})
            fulfilled = sum(v * min(1.0, capacity / loads[k])
                            for k, v in a.items())
            p = dm - fulfilled
            if not a:
                p = dm
            prios.append((p, mid))
        prios.sort(reverse=True)

        for wid, m in self.c.workers.items():
            for gid in m.gpu_ids():
                g = m.gpus[gid]
                if len(g.loading) >= self.max_loads:
                    continue
                for p, mid in prios:
                    if p <= 0:
                        break
                    if g.pagecache.contains(mid):
                        continue
                    model = self.c.models[mid]
                    pages = model.pages(g.pagecache.page_bytes)
                    if not self._make_room(wid, gid, pages, now):
                        continue
                    load_t = self._load_est(mid)
                    a = Action(type=ActionType.LOAD, model_id=mid,
                               worker_id=wid, gpu_id=gid, earliest=now,
                               latest=now + self.load_window,
                               expected_duration=load_t)
                    self.c.send_action(a)
                    break  # one new LOAD per gpu per tick

    def _make_room(self, wid: str, gid: int, pages: int, now: float) -> bool:
        m = self.c.workers[wid]
        g = m.gpus[gid]
        guard = 0
        while g.pagecache.free_pages < pages and guard < 64:
            guard += 1
            active = set(g.loading)
            # don't evict models with pending demand if avoidable
            busy = {mid for mid, q in self.queues.items() if q}
            victim = g.pagecache.lru_candidate(exclude=active | busy)
            if victim is None:
                victim = g.pagecache.lru_candidate(exclude=active)
            if victim is None:
                return False
            a = Action(type=ActionType.UNLOAD, model_id=victim,
                       worker_id=wid, gpu_id=gid, earliest=now,
                       latest=now + 1.0, expected_duration=1e-5)
            self.c.send_action(a)
        return g.pagecache.free_pages >= pages
