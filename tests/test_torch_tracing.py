"""The port's in-program timing of the serving path: each INFER's phases
(``Phases`` on the ``Result``), the controller's dispatch stamps and the
phases on each ``ActionRecord``, their JSONL and wire forms, and the
``record_function`` ranges an active profiler session sees.

The control-plane files that carry these fields differ from the JAX
package's, so the port's in-process stack is held to the reference's
decisions instead of its source: the same actions, in the same order, and
the same request outcomes, on a virtual clock."""
import dataclasses
import importlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.actions import (Action, ActionType, Phases, Request,
                                      Result, ResultStatus)
from repro_torch.core.clock import EventLoop, RealClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import ModelDef, Worker
from repro_torch.runtime import protocol
from repro_torch.runtime.controller import ControllerServer
from repro_torch.runtime.transport import LoopbackLink
from repro_torch.runtime.worker import WorkerHost
from repro_torch.serving import engine
from repro_torch.serving.engine import (TorchBackend, make_lm_decode_model,
                                        make_resnet_model, seed_engines)
from repro_torch.telemetry.events import ActionRecord
from repro_torch.telemetry.recorder import Recorder
from repro_torch.telemetry.reports import load_jsonl

PHASE_FIELDS = ("input_s", "launch_s", "wait_s", "device_s")


# ------------------------------------------------------------- decisions
def _decisions(pkg, kind, seed, n_models, device_memory):
    """The actions ``pkg``'s in-process Controller + ClockworkScheduler +
    Worker(SimBackend) sends on a VirtualClock, in order, the requests'
    outcomes and the ActionRecords' common fields."""
    sim = importlib.import_module(f"{pkg}.serving.simulator")
    workload = importlib.import_module(f"{pkg}.serving.workload")
    sched = importlib.import_module(f"{pkg}.core.scheduler")
    models = {f"m{i}": sim.table1_modeldef(f"m{i}") for i in range(n_models)}
    cl = sim.build_cluster(models, scheduler=sched.ClockworkScheduler(),
                           device_memory=device_memory, seed=seed,
                           preload=list(models)[:2])
    sent = []
    send = cl.controller.send_action

    def record(a):
        send(a)
        sent.append((a.type.value, a.model_id, a.worker_id, a.gpu_id,
                     a.batch_size, a.earliest, a.latest,
                     a.expected_duration, a.issued_at))

    cl.controller.send_action = record
    cl.attach_clients(workload.build_workload(
        cl.loop, cl.submit, list(models), kind=kind, slo=0.100, rate=40.0,
        duration=1.5, seed=seed))
    cl.run(2.0)
    outcomes = [(r.model_id, r.arrival, r.status, r.completion)
                for r in cl.controller.completed]
    records = [(a.action_type, a.model_id, a.status, a.batch_size,
                a.t_received, a.t_start, a.t_end, a.actual, a.predicted)
               for a in cl.recorder.iter_actions()]
    return sent, outcomes, records, cl.controller.summary()


@pytest.mark.parametrize("kind,seed,n_models,device_memory", [
    ("open", 4, 6, 32e9),
    ("closed", 7, 4, 32e9),
    ("maf", 10, 6, 32e9),
    # 12 models in a page cache that holds a few: LOADs and evictions
    ("open", 13, 12, 1.5e9),
], ids=["open", "closed", "maf", "cold_starts"])
def test_in_process_decisions_match_reference(kind, seed, n_models,
                                              device_memory):
    ref = _decisions("repro", kind, seed, n_models, device_memory)
    port = _decisions("repro_torch", kind, seed, n_models, device_memory)
    sent, outcomes, records, summary = ref
    assert summary["goodput"] > 0 and len(sent) > 10
    if n_models == 12:
        assert any(a[0] == "LOAD" for a in sent[2:])
    assert port[0] == sent
    assert port[1] == outcomes
    assert port[2] == records
    assert port[3] == summary


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("factory", [
    lambda: make_resnet_model("r", scale=16, img=32, batches=(1, 2),
                              device="cpu"),
    lambda: make_lm_decode_model("q", batches=(1, 2), device="cpu"),
], ids=["resnet", "lm_decode"])
def test_torch_model_times_each_phase_on_cpu(factory):
    tm = factory()
    tm.load()
    for batch in (1, 2):
        d = tm.run(batch, action_id=3)
        p = tm.last_phases
        assert p.launch_s + p.wait_s == d
        assert p.input_s > 0 and p.launch_s > 0 and p.wait_s >= 0
        assert p.device_s is None


def _infer_once(backend, model_id, batch=1, action_id=42):
    a = Action(type=ActionType.INFER, model_id=model_id, worker_id="w0",
               gpu_id=0, earliest=0.0, latest=1.0, expected_duration=0.01,
               batch_size=batch, id=action_id)
    return backend.exec_duration(ModelDef(model_id, 0, {}), a)


def test_backend_hands_over_the_phases_of_its_last_infer_once():
    tm = make_resnet_model("r", scale=16, img=32, batches=(1, 2),
                           device="cpu")
    backend = TorchBackend({"r": tm})
    d = _infer_once(backend, "r", batch=2, action_id=42)
    assert backend.take_phases(41) is None
    p = backend.take_phases(42)
    assert p is tm.last_phases and max(p.launch_s + p.wait_s, 1e-6) == d
    assert backend.take_phases(42) is None


def test_profiler_session_sees_the_infer_and_its_phases():
    tm = make_resnet_model("r", scale=16, img=32, batches=(1, 2),
                           device="cpu")
    backend = TorchBackend({"r": tm})
    tm.load()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _infer_once(backend, "r", batch=2, action_id=42)
    ranges = [e for e in prof.events() if e.name.startswith("clockwork.")]
    infer = [e for e in ranges if e.name.split(" ")[0] == "clockwork.infer"]
    assert [e.name for e in infer] == [
        "clockwork.infer action=42 model=r batch=2 bucket=2"]
    inner = [e for e in ranges if e is not infer[0]]
    assert [e.name for e in inner] == ["clockwork.infer.input",
                                       "clockwork.infer.launch",
                                       "clockwork.infer.wait"]
    span = infer[0].time_range
    for e in inner:
        assert e.cpu_parent is infer[0]
        assert span.start <= e.time_range.start <= e.time_range.end \
            <= span.end


def test_lm_forward_ranges_split_cache_from_step():
    tm = make_lm_decode_model("q", batches=(1,), device="cpu")
    tm.load()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tm.run(1, action_id=5)
    names = [e.name for e in prof.events()
             if e.name.startswith("clockwork.")]
    assert names == ["clockwork.infer action=5 model=q batch=1 bucket=1",
                     "clockwork.infer.input", "clockwork.infer.launch",
                     "clockwork.decode.cache", "clockwork.decode.step",
                     "clockwork.infer.wait"]


def test_no_range_is_entered_without_a_session(monkeypatch):
    made = []

    def counting(name, *a, **kw):
        made.append(name)
        return torch.profiler.record_function(name, *a, **kw)

    monkeypatch.setattr(engine, "record_function", counting)
    lm = make_lm_decode_model("q", batches=(1,), device="cpu")
    backend = TorchBackend({"q": lm})
    lm.load()
    _infer_once(backend, "q")
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        _infer_once(backend, "q", action_id=43)
    assert len(made) == 6


# ------------------------------------------------------- records, stamps
def _serve_tiny(wire: bool):
    """Twelve requests to a tiny ResNet on a TorchBackend worker, on a
    RealClock, in process or behind a WorkerHost and a ControllerServer
    over a LoopbackLink; returns the controller's Recorder."""
    loop = EventLoop(RealClock())
    tm = make_resnet_model("rt", scale=16, img=32, batches=(1, 2, 4),
                           device="cpu")
    profiles = seed_engines({"rt": tm})
    models = {"rt": tm.modeldef()}
    controller = Controller(loop, models, ClockworkScheduler(),
                            action_delay=1e-4)
    worker = Worker("w0", loop, TorchBackend({"rt": tm}), models, n_gpus=1)
    if wire:
        server = ControllerServer(controller)
        link = LoopbackLink(loop)
        server.adopt(link.a)
        host = WorkerHost(worker, link.b, profiles=profiles)
        host.register()
    else:
        controller.add_worker(worker, profiles=profiles)
    for _ in range(12):
        controller.on_request(Request(model_id="rt", arrival=loop.now(),
                                      slo=5.0))
        loop.run_until(loop.now() + 0.02)
    loop.run_until(loop.now() + 3.0)
    if wire:
        host.shutdown()
        loop.run_until(loop.now() + 0.1)
    return controller.recorder


@pytest.mark.parametrize("wire", [False, True], ids=["in_process", "wire"])
def test_infer_records_hold_dispatch_stamps_and_phases(wire):
    recs = [a for a in _serve_tiny(wire).iter_actions()
            if a.action_type == "INFER" and a.status == "SUCCESS"]
    assert len(recs) >= 4
    for a in recs:
        assert a.issued is not None and a.earliest is not None
        assert a.earliest <= a.latest
        assert a.issued <= a.t_received <= a.t_start
        assert a.t_start >= a.earliest - 1e-9
        assert a.input_s > 0 and a.launch_s > 0 and a.wait_s >= 0
        assert a.device_s is None
        assert a.actual == max(a.launch_s + a.wait_s, 1e-6)
        assert a.predicted is not None


def test_sim_records_hold_stamps_and_no_phases():
    sim = importlib.import_module("repro_torch.serving.simulator")
    models = {f"m{i}": sim.table1_modeldef(f"m{i}") for i in range(2)}
    cl = sim.build_cluster(models, seed=1)
    for t in (0.01, 0.02, 0.2):
        for mid in models:
            cl.loop.schedule(t, lambda mid=mid: cl.submit(
                Request(model_id=mid, arrival=cl.loop.now(), slo=0.1)))
    cl.run(1.0)
    recs = list(cl.recorder.iter_actions())
    assert {a.action_type for a in recs} == {"LOAD", "INFER"}
    for a in recs:
        assert a.issued is not None and a.earliest <= a.latest
        assert all(getattr(a, f) is None for f in PHASE_FIELDS)


def _record(recorder, phases, with_action=True):
    result = Result(action_id=9, action_type=ActionType.INFER,
                    model_id="m", worker_id="w0", gpu_id=0,
                    status=ResultStatus.SUCCESS, t_start=1.5, t_end=1.52,
                    duration=0.02, batch_size=2, request_ids=(3, 4),
                    t_received=1.4, phases=phases)
    action = Action(type=ActionType.INFER, model_id="m", worker_id="w0",
                    gpu_id=0, earliest=1.45, latest=1.6,
                    expected_duration=0.025, batch_size=2,
                    request_ids=(3, 4), id=9, issued_at=1.39)
    return recorder.record_action(result, action if with_action else None)


@pytest.mark.parametrize("how", ["export", "stream"])
def test_new_fields_survive_jsonl(tmp_path, how):
    rec = Recorder()
    path = str(tmp_path / "t.jsonl")
    if how == "stream":
        rec.stream_to(path)
    a = _record(rec, Phases(0.001, 0.015, 0.005, 0.018))
    b = _record(rec, None, with_action=False)
    if how == "stream":
        rec.close_stream()
    else:
        rec.export_jsonl(path)
    assert (a.issued, a.earliest, a.latest) == (1.39, 1.45, 1.6)
    assert (a.predicted, a.input_s, a.device_s) == (0.025, 0.001, 0.018)
    assert b.predicted is None and b.issued is None and b.launch_s is None
    assert load_jsonl(path)["actions"] == [a, b]


def test_an_action_line_from_before_the_phases_loads(tmp_path):
    old = {"kind": "action", "action_id": 1, "action_type": "INFER",
           "model_id": "m", "worker_id": "w0", "gpu_id": 0,
           "batch_size": 1, "status": "SUCCESS", "t_received": 0.1,
           "t_start": 0.2, "t_end": 0.3, "actual": 0.1, "predicted": 0.12,
           "request_ids": [7]}
    path = tmp_path / "old.jsonl"
    path.write_text(json.dumps(old) + "\n")
    (a,) = load_jsonl(str(path))["actions"]
    assert a == ActionRecord(
        action_id=1, action_type="INFER", model_id="m", worker_id="w0",
        gpu_id=0, batch_size=1, status="SUCCESS", t_received=0.1,
        t_start=0.2, t_end=0.3, actual=0.1, predicted=0.12,
        request_ids=(7,))
    assert a.issued is None and a.device_s is None


@pytest.mark.parametrize("phases", [
    None, Phases(0.001, 0.015, 0.005, 0.018), Phases(0.001, 0.015, 0.005)],
    ids=["none", "card", "cpu"])
def test_result_round_trips_through_the_protocol(phases):
    r = Result(action_id=9, action_type=ActionType.INFER, model_id="m",
               worker_id="w0", gpu_id=0, status=ResultStatus.SUCCESS,
               t_start=1.5, t_end=1.52, duration=0.02, batch_size=2,
               request_ids=(3, 4), t_received=1.4, phases=phases)
    frame = protocol.encode_frame(protocol.result_msg(r))
    (msg,) = protocol.iter_frames(frame)
    assert ("phases" in msg["result"]) == (phases is not None)
    back = protocol.decode(protocol.result_from_wire, msg["result"])
    assert back == r
    assert dataclasses.asdict(back) == dataclasses.asdict(r)
