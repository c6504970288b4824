"""The Clockwork scheduler (Appendix B) — incremental implementation.

Strategies: for each model with pending requests and each supported batch
size b, a strategy's *required start time* is

    min(deadline of the b oldest requests) - est_exec(model, b)

Larger batches have earlier required starts and are preferred. Each EXEC
executor is kept busy `schedule_ahead` (5 ms) into the future by scanning the
strategy order: skip models not loaded on that executor, batch sizes with
insufficient requests, batch sizes that are too small when a larger one is
eligible, and strategies that cannot complete in time.

LOAD selection uses the demand/allocation estimates: per model demand d_m
(outstanding exec-seconds), allocations a_{m,g} inversely proportional to GPU
load, load priority p_m = d_m - sum_g a_{m,g} * capacity_g / l_g. The highest
positive-priority non-resident model is loaded; LRU victims are UNLOADed when
pages are needed.

Scalability (DESIGN.md §4): the original implementation rebuilt and re-sorted
the full (required_start, model, batch) strategy list after *every* scheduled
action, making one tick O(models × batches × actions) — at paper scale
(thousands of models) the control plane, not the GPUs, became the binding
constraint. This implementation produces bit-identical decisions with
incremental data structures:

  * one globally *maintained* sorted strategy list; a model's ≤|batches|
    entries are spliced out and re-inserted (bisect) only when that model is
    dirtied — by a queue change or a new profile measurement — so scheduling
    one action costs O(log n) maintenance instead of an O(n·b log n·b)
    rebuild;
  * per-model prefix-min deadline views, so feasibility checks and batch
    deadlines are O(1) lookups instead of re-deriving min(deadline) per
    candidate;
  * profiler estimates memoized per (model, batch) until that model's
    profile actually changes (they cannot change mid-tick);
  * `_drop_hopeless` keeps a per-queue min-deadline lower bound and skips
    queues that provably contain nothing to drop; when it must scan, it is
    a single rotate pass (the original restarted the scan after every
    deletion — O(n²) per queue);
  * `_demands` is O(1) per model (the original summed a constant in an
    O(n) loop) and the LOAD allocation loop computes the same values
    without building the per-model inverse/allocation dicts.

Decision behavior is bit-identical to the frozen pre-optimization copy in
`repro.core.scheduler_reference` — enforced by the seeded decision-
equivalence tests in tests/test_scheduler_perf.py. Per-tick wall latency is
recorded into the controller's Recorder as the `scheduler.tick_latency_s`
gauge (see telemetry reports / BENCH_scheduler.json).
"""
from __future__ import annotations

import bisect
import collections
import itertools
import time
from typing import Deque, Dict, List, Optional

from repro_torch.core.actions import Action, ActionType, Request, Result

DEFAULT_BATCHES = (1, 2, 4, 8, 16)

TICK_LATENCY_GAUGE = "scheduler.tick_latency_s"

_INF = float("inf")


class ClockworkScheduler:
    def __init__(self, *, schedule_ahead: float = 0.005,
                 batch_sizes=DEFAULT_BATCHES,
                 action_type: ActionType = ActionType.INFER,
                 load_window: float = 0.250,
                 max_loads_in_flight_per_gpu: int = 2):
        self.schedule_ahead = schedule_ahead
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.action_type = action_type
        self._atype_val = action_type.value   # enum .value is a slow descriptor
        self.load_window = load_window
        self.max_loads = max_loads_in_flight_per_gpu
        self.c: Optional["Controller"] = None
        self.queues: Dict[str, Deque[Request]] = collections.defaultdict(
            collections.deque)
        self._in_tick = False
        # ---- incremental strategy state -------------------------------
        self._active: set = set()        # models with nonempty queues
        self._dirty: set = set()         # models whose entries are stale
        self._sorted: List[tuple] = []   # global sorted (req_start, mid, b)
        self._entries: Dict[str, list] = {}   # mid -> its tuples in _sorted
        self._pmins: Dict[str, list] = {}     # mid -> prefix-min deadlines
        self._est_mem: Dict[str, dict] = {}   # mid -> {batch: estimate}
        self._qmin: Dict[str, float] = {}     # mid -> queue min-deadline (lb)
        self._dval: Dict[str, float] = {}     # mid -> len(q)·est1 (demand)
        self._hopeless_at: Dict[str, float] = {}  # mid -> qmin - est1
        self._wcache: Dict[str, tuple] = {}   # mid -> (res_ver, where tuple)
        # multiset of queued request ids: the failure/requeue race can put
        # the SAME request in a queue twice (both implementations do), and
        # the dead-request hint below must see the copy that remains queued
        self._queued_ids: Dict[int, int] = {}
        self._scan_force: set = set()    # models that may hold dead requests
        self._qpos: Dict[str, int] = {}  # mid -> queue-dict insertion rank
        self._qpos_seq = itertools.count()
        # (qpos, mid) for active models, kept sorted; deactivated models are
        # removed lazily (consumers skip empty queues), so activation is one
        # bisect.insort instead of a per-tick sort of the active set
        self._order: List[tuple] = []
        self._order_set: set = set()     # mids currently in _order
        self.last_tick_s = 0.0           # wall-clock latency of the last tick

    # ---------------------------------------------------------- interface
    def attach(self, controller):
        self.c = controller

    def on_topology_change(self):
        # workers added/removed or profiles re-seeded: cached estimates and
        # everything derived from them may all be stale
        self._est_mem.clear()
        self._dval.clear()
        self._hopeless_at.clear()
        self._dirty.update(self._active)

    def _admit(self, req: Request):
        mid = req.model_id
        pos = self._qpos.get(mid)
        if pos is None:
            pos = self._qpos[mid] = next(self._qpos_seq)
        self._active.add(mid)
        self._dirty.add(mid)
        self._dval.pop(mid, None)
        q_ids = self._queued_ids
        q_ids[req.id] = q_ids.get(req.id, 0) + 1
        if mid not in self._order_set:
            self._order_set.add(mid)
            bisect.insort(self._order, (pos, mid))
        cur = self._qmin.get(mid)
        if cur is None or req.deadline < cur:
            # unconditionally ensure the entry exists — an infinite-SLO
            # request must still establish qmin (=inf) for _drop_hopeless
            self._qmin[mid] = req.deadline
            self._hopeless_at.pop(mid, None)

    def on_request(self, req: Request):
        self.queues[req.model_id].append(req)
        self._admit(req)

    def requeue(self, req: Request):
        if req.status is not None:
            return
        self.queues[req.model_id].appendleft(req)
        self._admit(req)

    def on_result(self, result: Result):
        # a result updates this model's profiler window, staling the
        # estimates baked into its strategy entries and derived caches
        mid = result.model_id
        self._est_mem.pop(mid, None)
        self._dval.pop(mid, None)
        self._hopeless_at.pop(mid, None)
        self._dirty.add(mid)
        # worker-failure requeue race: a result can complete a request that
        # was requeued and is *still in the queue* — only a scan removes it,
        # so flag the model for a forced scan on the next tick
        queued = self._queued_ids
        reqs = self.c.requests
        for rid in result.request_ids:
            if rid in queued:
                req = reqs.get(rid)
                if req is not None and req.status is not None:
                    self._scan_force.add(req.model_id)
                    break

    def _unqueue_id(self, rid: int):
        n = self._queued_ids.get(rid, 0)
        if n <= 1:
            self._queued_ids.pop(rid, None)
        else:
            self._queued_ids[rid] = n - 1

    def has_pending(self) -> bool:
        """O(1) pending-work probe for the controller's ticker."""
        return bool(self._active)

    # ---------------------------------------------------------- estimates
    def _est(self, model_id: str, b: int) -> Optional[float]:
        return self.c.profiler.estimate(self._atype_val, model_id, b)

    def _est_or_scale(self, model_id: str, b: int) -> float:
        # memoized until this model's profile changes (on_result/topology)
        mem = self._est_mem.get(model_id)
        if mem is None:
            mem = self._est_mem[model_id] = {}
        e = mem.get(b)
        if e is None:
            e = self._est(model_id, b)
            if e is None:
                e = b * self.c.profiler.estimate_or(
                    self._atype_val, model_id, 1, 0.005)
            mem[b] = e
        return e

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
        t0 = time.perf_counter()
        now = self.c.loop.now()
        try:
            # lazily compact the active-order list once stale (deactivated)
            # entries dominate it
            if len(self._order) > 16 and len(self._order) > 2 * len(self._active):
                self._order = [e for e in self._order if self.queues[e[1]]]
                self._order_set = {mid for _, mid in self._order}
            self._drop_hopeless(now)
            self._schedule_exec(now)
            self._schedule_loads(now)
        finally:
            self._in_tick = False
            self.last_tick_s = time.perf_counter() - t0
            rec = getattr(self.c, "recorder", None)
            if rec is not None:
                rec.record_gauge(TICK_LATENCY_GAUGE, now, self.last_tick_s)

    # Drop requests that can no longer meet their SLO anywhere (§4.1: cancel
    # before fruitless work). A queue is scanned only if its min-deadline
    # lower bound says something may be hopeless (the bound goes stale only
    # downward, so skipping is always sound) or a result hinted that a dead
    # request may still be queued; the scan itself is a single rotate pass.
    def _drop_hopeless(self, now: float):
        queues = self.queues
        qmin = self._qmin
        hmap = self._hopeless_at
        scan_force = self._scan_force
        for _, mid in self._order:
            h = hmap.get(mid)
            if h is None:
                q = queues[mid]
                if not q:
                    continue
                est1 = self._est_or_scale(mid, 1)
                h = hmap[mid] = qmin[mid] - est1
            if h >= now and mid not in scan_force:
                continue
            q = queues[mid]
            if not q:
                continue
            est1 = self._est_or_scale(mid, 1)
            scan_force.discard(mid)
            changed = False
            new_min = _INF
            kept = []
            # survivors go to a side list, not back onto the deque: a
            # reject() callback may synchronously submit new requests for
            # this model, and those must stay behind the survivors
            for _ in range(len(q)):
                r = q.popleft()
                if r.status is not None:
                    self._unqueue_id(r.id)
                    changed = True
                    continue
                if r.deadline - est1 < now:
                    self._unqueue_id(r.id)
                    self.c.reject(r)
                    changed = True
                    continue
                if r.deadline < new_min:
                    new_min = r.deadline
                kept.append(r)
            for r in q:
                # whatever remains was submitted mid-scan by a reject()
                # callback — fold it into the fresh minimum so the bound is
                # exact, not merely a (degrading) lower bound
                if r.deadline < new_min:
                    new_min = r.deadline
            if kept:
                q.extendleft(reversed(kept))
            if q:
                qmin[mid] = new_min
                hmap[mid] = new_min - est1
            else:
                qmin.pop(mid, None)
                hmap.pop(mid, None)
                self._active.discard(mid)
            if changed:
                self._dirty.add(mid)
                self._dval.pop(mid, None)

    # ------------------------------------------------- strategy maintenance
    def _flush_dirty(self):
        """Splice each dirty model's entries out of the global sorted list
        and re-insert its fresh ones — O(b log n) per dirty model."""
        if not self._dirty:
            return
        lst = self._sorted
        for mid in self._dirty:
            for t in self._entries.get(mid, ()):
                i = bisect.bisect_left(lst, t)
                del lst[i]          # exact tuple: (req_start, mid, b) unique
            q = self.queues.get(mid)
            if not q:
                self._entries.pop(mid, None)
                self._pmins.pop(mid, None)
                continue
            n = len(q)
            pmins: List[float] = []
            cur = _INF
            for i, r in enumerate(q):
                if i >= self.batch_sizes[-1]:
                    break
                d = r.deadline
                if d < cur:
                    cur = d
                pmins.append(cur)
            smallest = self.batch_sizes[0]
            entries = []
            for b in self.batch_sizes:
                if b > n and b != smallest:
                    continue
                eff = b if b < n else n
                t = (pmins[eff - 1] - self._est_or_scale(mid, b), mid, b)
                entries.append(t)
                bisect.insort(lst, t)
            self._entries[mid] = entries
            self._pmins[mid] = pmins
        self._dirty.clear()

    # ---------------------------------------------------------------- EXEC
    def _schedule_exec(self, now: float):
        self._flush_dirty()
        if not self._sorted:
            return
        horizon = now + self.schedule_ahead
        for wid, m in self.c.workers.items():
            for gid in m.gpu_ids():
                g = m.gpus[gid]
                while g.exec_free_at < horizon:
                    picked = self._pick_strategy(now, g)
                    if picked is None:
                        break
                    _, mid, b = picked
                    q = self.queues[mid]
                    take = min(b, len(q))
                    reqs = [q.popleft() for _ in range(take)]
                    for r in reqs:
                        self._unqueue_id(r.id)
                    exec_t = self._est_or_scale(mid, take)
                    dl = min(r.deadline for r in reqs)
                    a = Action(type=self.action_type, model_id=mid,
                               worker_id=wid, gpu_id=gid,
                               earliest=now, latest=max(now, dl - exec_t),
                               expected_duration=exec_t, batch_size=take,
                               request_ids=tuple(r.id for r in reqs))
                    self._dirty.add(mid)
                    self._dval.pop(mid, None)
                    if not q:
                        self._active.discard(mid)
                        self._qmin.pop(mid, None)
                        self._hopeless_at.pop(mid, None)
                    self.c.send_action(a)
                    self._flush_dirty()
                    if not self._sorted:
                        return

    def _pick_strategy(self, now: float, g) -> Optional[tuple]:
        avail = now if now > g.exec_free_at else g.exec_free_at
        contains = g.pagecache.resident.__contains__
        loading = g.loading
        queues = self.queues
        pmins = self._pmins
        smallest = self.batch_sizes[0]
        seen_models = None
        for e in self._sorted:
            mid = e[1]
            if not contains(mid) or mid in loading:
                continue  # not resident on this executor's GPU
            if seen_models is not None and mid in seen_models:
                continue  # a larger batch for this model already failed
            b = e[2]
            n = len(queues[mid])
            if b > n and b != smallest:
                continue
            eff = b if b < n else n
            exec_t = self._est_or_scale(mid, eff)
            if avail + exec_t > pmins[mid][eff - 1]:
                # cannot finish in time on this executor
                if seen_models is None:
                    seen_models = {mid}
                else:
                    seen_models.add(mid)
                continue
            return e
        return None

    # ---------------------------------------------------------- LOAD/UNLOAD
    def _demands(self) -> Dict[str, float]:
        # test/introspection view; _schedule_loads fuses the same values
        # into its allocation pass without materializing this dict
        d = {}
        for _, mid in self._order:
            if self.queues[mid]:
                d[mid] = self._demand(mid)
        return d

    def _demand(self, mid: str) -> float:
        dm = self._dval.get(mid)
        if dm is None:
            dm = self._dval[mid] = \
                len(self.queues[mid]) * self._est_or_scale(mid, 1)
        return dm

    def _where_of(self, mid: str) -> tuple:
        """GPU keys holding `mid`, in worker-registration order — cached
        until the controller's residency version for the model changes."""
        c = self.c
        ver = c._res_ver.get(mid, 0)
        hit = self._wcache.get(mid)
        if hit is not None and hit[0] == ver:
            return hit[1]
        s = c._residency.get(mid)
        if not s:
            w = ()
        elif len(s) == 1:
            w = tuple(s)
        else:
            w = tuple(sorted(s, key=c._gpu_ord.__getitem__))
        self._wcache[mid] = (ver, w)
        return w

    def _schedule_loads(self, now: float):
        c = self.c
        workers = c.workers
        if not workers:
            return
        # a GPU at its in-flight LOAD cap can't accept work, so if every
        # GPU is saturated the whole allocation pass can have no effect —
        # skip it (LOAD completions only land between ticks)
        max_loads = self.max_loads
        gpus = []
        for wid, m in workers.items():
            for gid in m.gpu_ids():
                g = m.gpus[gid]
                if len(g.loading) < max_loads:
                    gpus.append((wid, gid, g))
        if not gpus:
            return
        queues = self.queues
        where_of = self._where_of
        wcache = self._wcache
        res_ver = c._res_ver
        # Demand d_m = len(q)·est1 per pending model (memoized until the
        # queue or profile changes), in queue-dict insertion order so every
        # FP accumulation below matches the reference implementation.
        # GPU loads l_g: demand allocated to each gpu — a model's demand
        # splits evenly over the GPUs holding it (one share value, no
        # per-key inverse/allocation dicts), and the GPUs holding it come
        # from the controller's residency index, not a scan over every GPU.
        mids: list = []
        dms: list = []
        wlist: list = []
        loads: Dict[tuple, float] = {}
        for _, mid in self._order:
            if not queues[mid]:
                continue
            dm = self._demand(mid)
            # inline fast path of _where_of (this loop visits every pending
            # model every tick); _where_of remains the only writer/slow path
            hit = wcache.get(mid)
            w = hit[1] if hit is not None and hit[0] == res_ver.get(mid, 0) \
                else where_of(mid)
            mids.append(mid)
            dms.append(dm)
            wlist.append(w)
            if w:
                v = dm * 1.0 / len(w)
                for k in w:
                    loads[k] = loads.get(k, 1e-6) + v
        if not mids:
            return
        # priorities: only positive ones can be picked, and the pick loop
        # stops at the first non-positive, so non-positive entries are dead
        capacity = self.schedule_ahead * 50  # exec-seconds per horizon unit
        prios = []
        # nothing between the two passes mutates residency, so the pass-1
        # `where` tuples are still exact here
        for i in range(len(mids)):
            mid = mids[i]
            dm = dms[i]
            w = wlist[i]
            if not w:
                p = dm
            else:
                v = dm * 1.0 / len(w)
                fulfilled = 0
                for k in w:
                    f = capacity / loads[k]
                    if f > 1.0:
                        f = 1.0
                    fulfilled += v * f
                p = dm - fulfilled
            if p > 0:
                prios.append((p, mid))
        if not prios:
            return
        prios.sort(reverse=True)

        # `gpus` was filtered on the in-flight LOAD cap up front; a GPU's
        # loading set only grows here through its own send, after which we
        # break — so the filter matches the reference's per-GPU recheck
        for wid, gid, g in gpus:
            resident = g.pagecache.resident
            for p, mid in prios:
                if mid in resident:
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
            victim = g.pagecache.lru_candidate(exclude=active | self._active)
            if victim is None:
                victim = g.pagecache.lru_candidate(exclude=active)
            if victim is None:
                return False
            a = Action(type=ActionType.UNLOAD, model_id=victim,
                       worker_id=wid, gpu_id=gid, earliest=now,
                       latest=now + 1.0, expected_duration=1e-5)
            self.c.send_action(a)
        return g.pagecache.free_pages >= pages
