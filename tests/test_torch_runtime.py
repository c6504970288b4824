"""The port's copied distributed runtime (``repro_torch.runtime``): the
loopback cluster makes the reference's decisions on the same models, seed
and workload, and the wire protocol carries a real TorchBackend worker on a
RealClock (the ``runtime`` phase of chip_smoke.py at CPU size)."""
import importlib

import pytest

from repro_torch.core.actions import Request
from repro_torch.core.clock import EventLoop, RealClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import Worker
from repro_torch.runtime.client import RemoteClient
from repro_torch.runtime.controller import ControllerServer
from repro_torch.runtime.transport import LoopbackLink
from repro_torch.runtime.worker import WorkerHost
from repro_torch.serving.engine import (TorchBackend, make_resnet_model,
                                        seed_engines)


def _loopback_summary(pkg, kind):
    """controller.summary() of ``pkg``'s loopback cluster over six Table-1
    models, seed 4, the ``kind`` workload from build_workload."""
    sim = importlib.import_module(f"{pkg}.serving.simulator")
    harness = importlib.import_module(f"{pkg}.runtime.harness")
    workload = importlib.import_module(f"{pkg}.serving.workload")
    sched = importlib.import_module(f"{pkg}.core.scheduler")
    models = {f"m{i}": sim.table1_modeldef(f"m{i}") for i in range(6)}
    cl = harness.build_loopback_cluster(
        models, scheduler=sched.ClockworkScheduler(), seed=4)
    cl.attach_clients(workload.build_workload(
        cl.loop, cl.submit, list(models), kind=kind, slo=0.100, rate=40.0,
        duration=1.2, seed=10))
    cl.controller.start_heartbeats()
    cl.run(1.5)
    return cl.controller.summary()


@pytest.mark.parametrize("kind", ["open", "closed", "maf"])
def test_loopback_cluster_matches_reference(kind):
    ref = _loopback_summary("repro", kind)
    assert ref["total"] > 0 and ref["goodput"] > 0
    assert _loopback_summary("repro_torch", kind) == ref


def test_torch_worker_over_the_wire_protocol():
    """A tiny ResNet on a TorchBackend worker behind a WorkerHost, a
    ControllerServer and a RemoteClient, each hop a LoopbackLink that
    encodes and decodes every frame, on a RealClock."""
    loop = EventLoop(RealClock())
    tm = make_resnet_model("rt", scale=16, img=32, batches=(1, 2, 4),
                           device="cpu")
    profiles = seed_engines({"rt": tm})
    models = {"rt": tm.modeldef()}
    controller = Controller(loop, models, ClockworkScheduler(),
                            action_delay=1e-4)
    server = ControllerServer(controller)
    worker_link, client_link = LoopbackLink(loop), LoopbackLink(loop)
    server.adopt(worker_link.a)
    host = WorkerHost(Worker("w0", loop, TorchBackend({"rt": tm}), models,
                             n_gpus=1), worker_link.b, profiles=profiles)
    host.register()
    assert host.registered and "w0" in controller.workers
    server.adopt(client_link.a)
    client = RemoteClient(loop, client_link.b)
    for _ in range(12):
        client.submit(Request(model_id="rt", arrival=loop.now(), slo=5.0))
        loop.run_until(loop.now() + 0.02)
    loop.run_until(loop.now() + 3.0)
    s = client.summary()
    assert s["sent"] == 12 and s["in_flight"] == 0
    assert s["goodput"] >= 10, s
    assert controller.profiler.estimate("INFER", "rt", 1) > 0
    host.shutdown()
    loop.run_until(loop.now() + 0.1)
    assert host.closed and "w0" not in controller.workers
