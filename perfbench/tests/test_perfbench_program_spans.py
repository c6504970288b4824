"""The readers of the program's own INFER timing (``queue_wait_ms_p99``,
``worker_late_ms_p99``, ``input_ms_per_req``, ``launch_ms_per_req``,
``device_ms_per_req``): a tiny traced run of each cell on the CPU reports
all five, with CUDA events stood in for by host-clock stamps (the CPU has
none: there ``device_ms_per_req`` reads nothing); and records of a program
that holds none of these fields give None, not 0."""
import math
import time
import types
from pathlib import Path

import pytest
import torch

from perfbench.harness import manifest, serve
from perfbench.tests.tiny import QWEN2, RESNET

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 23
CELLS = {"resnet50.poisson": RESNET, "qwen2-0.5b.decode": QWEN2}
NEW = ("queue_wait_ms_p99", "worker_late_ms_p99", "input_ms_per_req",
       "launch_ms_per_req", "device_ms_per_req")


class _HostEvent:
    """A stand-in for ``torch.cuda.Event``: the host clock at ``record``."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _traced_run(cell, events: bool, monkeypatch):
    c = manifest.load(ROOT, cell)
    over = CELLS[cell]
    deploy = c.adapter().build(c.sizes, c.cell, SEED, torch.device("cpu"),
                               over["sizes"])
    if events:
        monkeypatch.setattr(torch.cuda, "current_stream", lambda d: None)
        for tm in deploy.engines.values():
            tm._events = (_HostEvent(), _HostEvent())
    traffic = {**c.cell["traffic"], **over["traffic"]}
    rec = serve.run(deploy, traffic, SEED, 2, traced=True,
                    t_start=time.monotonic())
    readers = {m["name"]: c.reader(m) for m in c.per_layer}
    return {n: readers[n](rec) for n in (*NEW, "exec_ms_per_req.rate")}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_tiny_traced_run_reports_the_programs_timing(cell, monkeypatch):
    got = _traced_run(cell, True, monkeypatch)
    for name in NEW:
        assert got[name] is not None and math.isfinite(got[name]), name
        assert got[name] >= 0, name
    assert 0 < got["launch_ms_per_req"] <= got["exec_ms_per_req.rate"]
    assert got["input_ms_per_req"] > 0
    assert got["device_ms_per_req"] <= got["launch_ms_per_req"]


def test_on_the_cpu_device_time_reads_nothing(monkeypatch):
    got = _traced_run("resnet50.poisson", False, monkeypatch)
    assert got["device_ms_per_req"] is None
    assert got["launch_ms_per_req"] > 0


def test_records_without_the_fields_read_none():
    """What a program without in-program timing gives the readers."""
    sent = types.SimpleNamespace(req=types.SimpleNamespace(id=1), sent=0.5)
    old = types.SimpleNamespace(status="SUCCESS", request_ids=(1,),
                                batch_size=1, t_start=0.6)
    rec = types.SimpleNamespace(requests=[sent], actions=[old])
    c = manifest.load(ROOT, "resnet50.poisson")
    readers = {m["name"]: c.reader(m) for m in c.per_layer}
    assert {n: readers[n](rec) for n in NEW} == dict.fromkeys(NEW)
