"""Workload generators: closed-loop clients, open-loop Poisson clients, and
an MAF-like trace synthesizer (Microsoft Azure Functions workload shapes:
sustained / bursty / periodic / cold — §6.5 of the paper).

Every generator drives an arbitrary `submit(Request)` callable, so the
same seeded workload runs against an in-process controller
(`Cluster.submit`), a loopback `RemoteClient.submit`, or a real TCP
client in the load-generator process (`python -m repro_torch.runtime.loadgen`)
— `build_workload` is the one factory all three paths share."""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.actions import Request
from repro_torch.core.clock import EventLoop


class ClosedLoopClient:
    """`concurrency` outstanding requests; next sent upon each response."""

    def __init__(self, loop: EventLoop, submit: Callable[[Request], None],
                 model_id: str, slo: float, concurrency: int = 1,
                 start: float = 0.0, stop: Optional[float] = None):
        self.loop = loop
        self.submit = submit
        self.model_id = model_id
        self.slo = slo
        self.concurrency = concurrency
        self.stop = stop
        self.sent = 0
        for _ in range(concurrency):
            loop.schedule(start, self._send)

    def _send(self):
        now = self.loop.now()
        if self.stop is not None and now >= self.stop:
            return
        r = Request(model_id=self.model_id, arrival=now, slo=self.slo)
        self.sent += 1
        self.submit(r)

    def on_response(self, req: Request):
        if req.model_id == self.model_id:
            self.loop.schedule(self.loop.now(), self._send)


class OpenLoopClient:
    """Poisson arrivals at `rate` r/s until `stop`."""

    def __init__(self, loop: EventLoop, submit: Callable[[Request], None],
                 model_id: str, slo: float, rate: float, start: float = 0.0,
                 stop: float = 60.0, seed: int = 0):
        self.loop = loop
        self.submit = submit
        self.model_id = model_id
        self.slo = slo
        self.rate = rate
        self.stop = stop
        self.rng = random.Random(seed)
        self.sent = 0
        if rate > 0:
            loop.schedule(start + self.rng.expovariate(rate), self._send)

    def _send(self):
        now = self.loop.now()
        if now >= self.stop:
            return
        self.sent += 1
        self.submit(Request(model_id=self.model_id, arrival=now,
                            slo=self.slo))
        self.loop.schedule(now + self.rng.expovariate(self.rate), self._send)


class VariableRateClient:
    """Open-loop with a piecewise-constant rate function (trace replay)."""

    def __init__(self, loop: EventLoop, submit: Callable[[Request], None],
                 model_id: str, slo: float, rate_fn: Callable[[float], float],
                 start: float = 0.0, stop: float = 60.0, seed: int = 0,
                 max_rate: float = 1000.0):
        self.loop = loop
        self.submit = submit
        self.model_id = model_id
        self.slo = slo
        self.rate_fn = rate_fn
        self.stop = stop
        self.rng = random.Random(seed)
        self.max_rate = max_rate
        self.sent = 0
        loop.schedule(start, self._send)   # thinning sampler

    def _send(self):
        # Lewis thinning: sample at max_rate, accept with rate/max_rate
        now = self.loop.now()
        if now >= self.stop:
            return
        dt = self.rng.expovariate(self.max_rate)
        t = now + dt
        if t >= self.stop:
            return

        def fire():
            r = self.rate_fn(self.loop.now())
            if self.rng.random() < r / self.max_rate:
                self.sent += 1
                self.submit(Request(model_id=self.model_id,
                                    arrival=self.loop.now(), slo=self.slo))
            self._send()

        self.loop.schedule(t, fire)


# ------------------------------------------------------------- the factory

WORKLOAD_KINDS = ("open", "closed", "maf")


def build_workload(loop: EventLoop, submit: Callable[[Request], None],
                   model_ids: Sequence[str], *, kind: str = "open",
                   slo: float = 0.100, rate: float = 10.0,
                   concurrency: int = 4, start: float = 0.0,
                   duration: float = 60.0, seed: int = 0,
                   total_rate: Optional[float] = None,
                   max_rate: float = 1000.0) -> list:
    """Build the standard generator mix over any submit callable.

    kind "open": one Poisson OpenLoopClient per model at `rate` r/s;
    "closed": one ClosedLoopClient per model with `concurrency`
    outstanding; "maf": MAF-shaped VariableRateClients splitting
    `total_rate` (default `rate * len(model_ids)`) across models. `start`
    offsets every generator onto the caller's clock (a TCP loadgen joins
    at loop.now() > 0; rate functions are phase-shifted to match), and
    `seed` makes the whole mix reproducible.
    """
    stop = start + duration
    clients: list = []
    if kind == "open":
        for i, mid in enumerate(model_ids):
            clients.append(OpenLoopClient(loop, submit, mid, slo, rate=rate,
                                          start=start, stop=stop,
                                          seed=seed + i))
    elif kind == "closed":
        for i, mid in enumerate(model_ids):
            clients.append(ClosedLoopClient(loop, submit, mid, slo,
                                            concurrency=concurrency,
                                            start=start, stop=stop))
    elif kind == "maf":
        fns = maf_like_rates(len(model_ids),
                             total_rate if total_rate is not None
                             else rate * len(model_ids),
                             duration, seed=seed)
        for i, mid in enumerate(model_ids):
            fn = fns[f"m{i}"]
            clients.append(VariableRateClient(
                loop, submit, mid, slo,
                rate_fn=lambda t, fn=fn, s=start: fn(t - s),
                start=start, stop=stop, seed=seed + i, max_rate=max_rate))
    else:
        raise ValueError(f"unknown workload kind {kind!r}; "
                         f"choose from {WORKLOAD_KINDS}")
    return clients


# ----------------------------------------------------------- MAF-like trace

def maf_like_rates(n_models: int, total_rate: float, duration: float,
                   seed: int = 0) -> Dict[str, Callable[[float], float]]:
    """Synthesize per-model rate functions with MAF-like shape mix:
    ~10% sustained heavy (zipf-weighted), ~30% bursty, ~20% periodic
    (60 s / 900 s spikes), ~40% cold/rare."""
    rng = random.Random(seed)
    weights = [1.0 / (i + 1) ** 1.1 for i in range(n_models)]
    wsum = sum(weights)
    fns = {}
    for i in range(n_models):
        mid = f"m{i}"
        base = total_rate * weights[i] / wsum
        kind = rng.random()
        if kind < 0.10:
            def fn(t, b=base):
                return b * 3.0
        elif kind < 0.40:
            period = rng.uniform(5, 60)
            phase = rng.uniform(0, period)
            burst = rng.uniform(2, 12)

            def fn(t, b=base, p=period, ph=phase, k=burst):
                return b * (k if ((t + ph) % p) < p * 0.2 else 0.3)
        elif kind < 0.60:
            period = rng.choice([60.0, 900.0])
            phase = rng.uniform(0, period)

            def fn(t, b=base, p=period, ph=phase):
                return b * (10.0 if ((t + ph) % p) < 2.0 else 0.5)
        else:
            def fn(t, b=base):
                return b * 0.2
        fns[mid] = fn
    return fns
