"""Live-cluster harnesses for the distributed runtime.

`build_loopback_cluster` mirrors `serving.simulator.build_cluster` exactly
— same construction order, worker ids, backend seeds, profile seeding —
but routes every controller<->worker interaction through the runtime's
wire protocol over deterministic loopback channels. With zero transport
latency the event sequence is *identical* to the in-process path (the
loopback delivers synchronously inside the sender's event), which is what
the decision-trace equivalence test pins down; with latency/jitter/drop
configured it becomes a reproducible network-condition testbed on the
virtual clock.

The returned object is the ordinary `serving.simulator.Cluster`, so
clients, TimeSeries sampling, and telemetry reports all work unchanged;
`cluster.runtime` additionally exposes the server, hosts, and links plus
a `shutdown()` that winds the daemons down gracefully (flushing their
telemetry) and drains the loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.clock import EventLoop, VirtualClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import ModelDef, Worker
from repro_torch.runtime.client import RemoteClient
from repro_torch.runtime.controller import ControllerServer
from repro_torch.runtime.transport import LoopbackLink
from repro_torch.runtime.worker import WorkerHost
from repro_torch.serving.simulator import (Cluster, make_sim_worker,
                                     place_preload, seed_profiles)
from repro_torch.telemetry.profile_store import ProfileStore
from repro_torch.telemetry.recorder import Recorder


@dataclasses.dataclass
class LoopbackRuntime:
    """Handle to the distributed plumbing behind a loopback Cluster."""
    server: ControllerServer
    hosts: List[WorkerHost]
    links: List[LoopbackLink]
    loop: EventLoop
    # RemoteClients attached via attach_remote_client (third tier)
    clients: List[RemoteClient] = dataclasses.field(default_factory=list)

    def shutdown(self, drain_s: float = 1.0) -> None:
        """Daemon-initiated graceful leave for every worker host (each
        flushes its telemetry buffer first), then drain the loop so all
        in-flight frames land. Virtual-clock only."""
        for h in self.hosts:
            if not h.closed:
                h.shutdown()
        self.loop.run_until(self.loop.now() + drain_s)

    @property
    def dropped_frames(self) -> int:
        return sum(l.dropped for l in self.links)


def build_loopback_cluster(
        models: Dict[str, ModelDef], *, n_workers: int = 1,
        gpus_per_worker: int = 1, scheduler=None,
        device_memory: float = 32e9, host_to_dev_bw: float = 12.3e9,
        noise: float = 0.0003, spike_prob: float = 0.0,
        spike_scale: float = 5.0, action_delay: float = 0.0005,
        seed: int = 0, preload: Optional[List[str]] = None,
        profile_store: Optional[ProfileStore] = None,
        recorder: Optional[Recorder] = None,
        latency: float = 0.0, jitter: float = 0.0, drop: float = 0.0,
        transport_seed: int = 12345,
        telemetry_interval: Optional[float] = 1.0,
        telemetry_batch: int = 16,
        fold_net_delay: bool = True) -> Cluster:
    """`build_cluster`, but with the process boundary in the middle.

    latency/jitter/drop configure the loopback links (seeded, virtual-
    clock deterministic). `fold_net_delay` seeds each worker mirror's
    `net_delay` with the known mean one-way delay so the scheduler's
    action windows account for the network, as the ControllerServer's
    RTT estimation would in a real deployment.
    """
    loop = EventLoop(VirtualClock())
    sched = scheduler if scheduler is not None else ClockworkScheduler()
    controller = Controller(loop, models, sched, action_delay=action_delay,
                            recorder=recorder)
    # estimation off: loopback delay is configured, not measured, so the
    # run stays bit-deterministic (and bit-identical to in-process at 0)
    server = ControllerServer(controller, estimate_net_delay=False)
    profiles = profile_store.seed_dict() if profile_store is not None \
        else seed_profiles(models, host_to_dev_bw)
    workers: List[Worker] = []
    hosts: List[WorkerHost] = []
    links: List[LoopbackLink] = []
    for i in range(n_workers):
        w = make_sim_worker(i, loop, models,
                            gpus_per_worker=gpus_per_worker,
                            device_memory=device_memory,
                            host_to_dev_bw=host_to_dev_bw, noise=noise,
                            spike_prob=spike_prob,
                            spike_scale=spike_scale, seed=seed)
        link = LoopbackLink(loop, latency=latency, jitter=jitter, drop=drop,
                            seed=transport_seed + i)
        server.adopt(link.a)
        host = WorkerHost(w, link.b,
                          profiles=profiles if i == 0 else None,
                          telemetry_interval=telemetry_interval,
                          telemetry_batch=telemetry_batch)
        host.register()
        workers.append(w)
        hosts.append(host)
        links.append(link)
    if latency > 0.0 or jitter > 0.0:
        # registration frames are in flight: complete membership before
        # the workload starts (advances virtual time by <= latency+jitter)
        loop.run_until(loop.now() + latency + jitter + 1e-9)
    mean_net = latency + 0.5 * jitter
    if fold_net_delay and mean_net > 0.0:
        for m in controller.workers.values():
            m.net_delay = mean_net
    place_preload(controller, workers, models, preload)
    return Cluster(loop=loop, controller=controller, workers=workers,
                   models=models,
                   runtime=LoopbackRuntime(server=server, hosts=hosts,
                                           links=links, loop=loop))


def attach_remote_client(cluster: Cluster, *, latency: float = 0.0,
                         jitter: float = 0.0, drop: float = 0.0,
                         transport_seed: int = 54321,
                         recorder: Optional[Recorder] = None
                         ) -> RemoteClient:
    """Connect a `RemoteClient` to a loopback cluster's ControllerServer
    over its own seeded LoopbackLink — the client tier of the paper's
    topology, on the virtual clock.

    At zero latency the SUBMIT/RESPONSE round-trip is synchronous inside
    the sender's event, so a seeded workload driven through the returned
    client produces a decision trace *identical* to in-process
    `attach_clients` (pinned by tests/test_client.py). With latency/
    jitter configured it reproduces client-side network conditions
    deterministically.
    """
    rt = cluster.runtime
    if not isinstance(rt, LoopbackRuntime):
        raise ValueError("attach_remote_client needs a loopback cluster "
                         "(build_cluster(transport='loopback'))")
    link = LoopbackLink(rt.loop, latency=latency, jitter=jitter, drop=drop,
                        seed=transport_seed)
    rt.server.adopt(link.a)
    client = RemoteClient(rt.loop, link.b, recorder=recorder)
    rt.links.append(link)
    rt.clients.append(client)
    return client
