"""One cell's Clockwork stack on a real clock, driven by the open-loop
schedule, with the benchmark's own records around it.

The stack is the port's: ``Controller`` + ``ClockworkScheduler`` + one
``Worker`` over ``TorchBackend`` on a ``RealClock`` (as
``chip_smoke.py:_serve`` builds it). The benchmark adds, from outside the
program:

* a sender that calls ``Controller.on_request`` for every request due,
  each stamped with the time it was due (``Request.arrival``), and notes
  when it was sent;
* ``RecordingBackend``, a ``TorchBackend`` that notes every INFER and LOAD
  it runs (start, seconds returned, requests, bucket);
* a wrapper of each model's ``forward`` that keeps a seeded sample of the
  output rows the window's INFERs computed for requests (not the bucket's
  padding rows), with the input row each used;
* in a traced run, ``record_function`` spans around the sender's
  ``on_request``, the controller's result path, the worker's dispatch, the
  backend, and the model's ``make_input`` and ``forward``, and the
  window's own span; one profiler session runs from before the warm-up to
  the end of the drain, and the trace is read only inside the window
  (``cell.py`` checks its kernel count against what the window's INFERs
  launched). Stopping a session takes seconds, so the window is never
  split into sessions: a stop inside it stalls the loop past every SLO.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench.harness import trace as tr
from perfbench.harness import traffic as tf
from perfbench.harness.weights import mix
from repro_torch.core.actions import Request
from repro_torch.core.clock import EventLoop, RealClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import Worker
from repro_torch.serving.engine import TorchBackend
from repro_torch.telemetry.recorder import Recorder

DRAIN_MAX_S = 60.0        # a window request may answer this long after the close
SAMPLE_ROWS = 256         # answered rows of window INFERs compared


@dataclasses.dataclass
class Sent:
    """One request of the schedule, as the benchmark saw it."""
    req: Request
    due: float            # loop time it was due (== req.arrival)
    sent: float           # loop time Controller.on_request was called

    @property
    def status(self):
        return self.req.status

    @property
    def completion(self):
        return self.req.completion


@dataclasses.dataclass
class Infer:
    t0: float             # loop time the backend started it
    seconds: float        # what TorchBackend returned
    model: str
    batch: int            # requests carried
    bucket: int           # rows computed


@dataclasses.dataclass
class Load:
    t0: float
    seconds: float
    model: str


@dataclasses.dataclass
class Sample:
    """One sampled output row of a window INFER and the input row it
    used."""
    model: str
    index: int            # the model's index in the deployment
    row: int              # the input pool's row (the adapter's input)
    output: torch.Tensor  # the program's output for that row


@dataclasses.dataclass
class Record:
    """Everything a metric reader sees of one run."""
    seconds: float                  # the nominal window length
    window: tuple                   # (start, end) loop times of the window
    requests: List[Sent]            # the window's requests
    infers: List[Infer]             # INFERs started in the window
    loads: List[Load]               # LOADs started in the window
    actions: list                   # the window's INFER ActionRecords
    setup_s: float
    window_trace: Optional[tuple] = None   # TracedWindow.read()
    trace: Optional[tr.Trace] = None       # kept by cell.py
    traced_infers: List[Infer] = dataclasses.field(default_factory=list)
    deployment: object = None       # the adapter's Deployment
    samples: List[Sample] = dataclasses.field(default_factory=list)


class Reservoir:
    """A uniform sample of ``k`` of the rows offered (Algorithm R), drawn
    from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.n = 0
        self.kept: List[Sample] = []

    def offer(self, make: Callable[[], Sample]):
        if self.n < self.k:
            self.kept.append(make())
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.kept[j] = make()
        self.n += 1


def _span(name: str, fn: Callable) -> Callable:
    label = tr.SPAN_PREFIX + name

    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return wrapped


class RecordingBackend(TorchBackend):
    """``TorchBackend`` that notes each INFER and LOAD it runs."""

    def __init__(self, engines, clock, spans: bool):
        super().__init__(engines)
        self.clock = clock
        self.infers: List[Infer] = []
        self.loads: List[Load] = []
        self.batch = 0                # requests of the INFER now running
        if spans:
            self.exec_duration = _span("backend.exec", self.exec_duration)
            self.load_duration = _span("backend.load", self.load_duration)

    def exec_duration(self, model, action) -> float:
        t0 = self.clock.now()
        self.batch = action.batch_size
        d = super().exec_duration(model, action)
        self.infers.append(Infer(t0, d, model.model_id, action.batch_size,
                                 self.models[model.model_id].bucket(
                                     action.batch_size)))
        return d

    def load_duration(self, model) -> float:
        t0 = self.clock.now()
        d = super().load_duration(model)
        self.loads.append(Load(t0, d, model.model_id))
        return d


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class TracedWindow:
    """One profiler session around the run: ``open`` and ``close`` mark
    the window with its span; ``read()`` gives (Trace or None, loop
    start, loop end, error)."""

    def __init__(self, loop):
        self.loop = loop
        self.prof = _profiler()
        self.prof.start()
        self.marker = torch.profiler.record_function(tr.WINDOW)

    def open(self):
        self.marker.__enter__()
        self.lo = self.loop.now()

    def close(self):
        self.marker.__exit__(None, None, None)
        self.hi = self.loop.now()

    def stop(self):
        self.prof.stop()

    def read(self):
        device, twin, spans = tr.read_profile(self.prof)
        try:
            if twin is None:
                raise tr.TraceError("the session holds no window span")
            return tr.summarize(device, twin, spans), self.lo, self.hi, None
        except tr.TraceError as e:
            return None, self.lo, self.hi, str(e)


def run(deploy, traffic: dict, seed: int, seconds: float, *, traced: bool,
        t_start: float) -> Record:
    """Warm up, measure for ``seconds``, drain; return the run's records.
    ``t_start`` is the process start on ``time.monotonic``'s clock."""
    engines = deploy.engines
    ids = list(engines)
    models = {mid: tm.modeldef() for mid, tm in engines.items()}
    profiles = {}
    for tm in engines.values():
        profiles.update(tm.seed_profiles())
    loop = EventLoop(RealClock())
    backend = RecordingBackend(engines, loop, traced)
    worker = Worker("w0", loop, backend, models, n_gpus=1)
    due, which = tf.schedule(traffic, len(ids), seed, seconds)
    recorder = Recorder(capacity=2 * len(due) + 1024)
    controller = Controller(
        loop, models, ClockworkScheduler(batch_sizes=deploy.buckets),
        recorder=recorder)
    controller.add_worker(worker, profiles=profiles)
    slo = traffic["slo_ms"] / 1e3
    warm = float(traffic["warmup_s"])

    reservoir = Reservoir(SAMPLE_ROWS, mix(seed, 1))
    window = [None, None]

    def capture(index, mid, fwd):
        def forward(p, x):
            out = fwd(p, x)
            if window[0] is not None and window[1] is None:
                start, _ = deploy.last_input
                for i in range(min(backend.batch, out.shape[0])):
                    reservoir.offer(lambda i=i: Sample(
                        mid, index, start + i, out[i]))
            return out
        return forward

    saved = [(tm, tm.forward, tm.make_input) for tm in engines.values()]
    for index, (mid, tm) in enumerate(engines.items()):
        tm.forward = capture(index, mid, tm.forward)
    on_request = controller.on_request
    if traced:
        on_request = _span("controller.on_request", on_request)
        worker.on_result = _span("controller.on_result", worker.on_result)
        worker.perform = _span("worker.perform", worker.perform)
        controller.scheduler.tick = _span("scheduler.tick",
                                          controller.scheduler.tick)
        for tm in engines.values():
            tm.forward = _span("model.forward", tm.forward)
            tm.make_input = _span("model.make_input", tm.make_input)

    traced_window = TracedWindow(loop) if traced else None
    to_monotonic = time.monotonic() - loop.now()     # loop time -> monotonic
    t_base = loop.now() + 0.05
    w0, w1 = t_base + warm, t_base + warm + seconds
    sent: List[Optional[Sent]] = [None] * len(due)
    pos = [0]
    resolved = [0]

    def on_response(req):
        if w0 <= req.arrival < w1:
            resolved[0] += 1

    controller.on_response = on_response

    def pump():
        i, now = pos[0], loop.now()
        while i < len(due) and t_base + due[i] <= now:
            r = Request(model_id=ids[which[i]], arrival=t_base + due[i],
                        slo=slo)
            sent[i] = Sent(r, r.arrival, loop.now())
            on_request(r)
            i += 1
        pos[0] = i
        if i < len(due):
            loop.schedule(t_base + due[i], pump)

    def open_window():
        if traced_window is not None:
            traced_window.open()
        window[0] = loop.now()

    def close_window():
        window[1] = loop.now()
        if traced_window is not None:
            traced_window.close()

    loop.schedule(t_base + due[0] if len(due) else t_base, pump)
    loop.schedule(w0, open_window)
    loop.schedule(w1, close_window)
    n_window = int(((due >= warm) & (due < warm + seconds)).sum())
    try:
        loop.run_until(w1)
        while resolved[0] < n_window and loop.now() < w1 + DRAIN_MAX_S:
            loop.run_until(loop.now() + 0.02)
    finally:
        if traced_window is not None:
            traced_window.stop()
        for tm, fwd, make in saved:
            tm.forward, tm.make_input = fwd, make
    setup_s = to_monotonic + w0 - t_start
    lo, hi = window
    in_w = [s for s in sent if s is not None and w0 <= s.due < w1]
    rec = Record(
        seconds=seconds, window=(lo, hi), requests=in_w,
        infers=[i for i in backend.infers if lo <= i.t0 < hi],
        loads=[x for x in backend.loads if lo <= x.t0 < hi],
        actions=[a for a in recorder.actions
                 if a.action_type == "INFER" and lo <= a.t_start < hi],
        setup_s=setup_s, deployment=deploy, samples=list(reservoir.kept))
    if n_window != len(in_w):
        raise RuntimeError(f"{n_window} window requests due, "
                           f"{len(in_w)} sent")
    if traced_window is not None:
        rec.window_trace = traced_window.read()
    return rec


def kernels_per_infer(tm, buckets) -> Dict[int, int]:
    """Device kernels one INFER of each bucket launches, counted once in
    set-up, all buckets in one profiler session: each INFER runs inside
    its own span and ends synchronised, so its kernels start inside it."""
    prof = _profiler()
    with prof:
        for b in buckets:
            with torch.profiler.record_function(f"{tr.SPAN_PREFIX}kpi.{b}"):
                tm.run(b)
    device, _, spans = tr.read_profile(prof)
    starts = [s for s, _, _, k in device if k == "kernel"]
    return {int(name.split(".")[-1]): sum(1 for t in starts if lo <= t <= hi)
            for lo, hi, name in spans if name.startswith("kpi.")}
