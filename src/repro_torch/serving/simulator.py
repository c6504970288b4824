"""Cluster simulation harness: builds controller + workers + clients on a
virtual clock and replays paper-scale experiments in seconds.

Model profiles come from two sources:
  * the paper's own Table 1 (v100 measurements) for the faithful
    ResNet-family reproduction, and
  * roofline-derived TPU v5e profiles for the assigned LM architectures
    (benchmarks/roofline.py writes them from dry-run artifacts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

from repro_torch.core.actions import ActionType, Request
from repro_torch.core.clock import EventLoop, VirtualClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import ModelDef, SimBackend, Worker
from repro_torch.telemetry.profile_store import ProfileStore
from repro_torch.telemetry.recorder import Recorder

# --- paper Table 1 (v100, TVM 0.7): model -> (weights MB, B1,B2,B4,B8,B16 ms)
PAPER_TABLE1 = {
    "resnet50_v2": (102.2, 2.73, 4.05, 5.87, 9.93, 17.3),
    "resnet18_v2": (46.7, 1.32, 1.81, 2.48, 4.42, 7.12),
    "resnet101_v2": (178.1, 5.51, 8.05, 11.83, 18.14, 33.57),
    "densenet121": (31.8, 3.80, 4.52, 6.55, 10.22, 17.91),
    "googlenet": (26.5, 1.54, 1.94, 2.69, 4.19, 7.11),
    "inceptionv3": (95.3, 4.46, 6.85, 10.99, 16.45, 26.17),
    "mobile_pose_mobilenet1.0": (20.0, 0.99, 1.72, 2.99, 5.67, 10.78),
    "resnest50": (109.8, 6.96, 9.47, 14.27, 29.94, 56.02),
    "resnext50_32x4d": (100.0, 2.18, 3.23, 5.35, 9.21, 17.42),
    "winograd_resnet18_v2": (77.4, 0.95, 1.17, 1.71, 2.81, 5.09),
}
PAPER_PCIE_BW = 12.3e9   # ~102.2MB / 8.32ms, v100 PCIe3 measured in Table 1


def table1_modeldef(model_id: str, family: str = "resnet50_v2") -> ModelDef:
    mb, b1, b2, b4, b8, b16 = PAPER_TABLE1[family]
    lat = {("INFER", b): ms / 1e3
           for b, ms in zip((1, 2, 4, 8, 16), (b1, b2, b4, b8, b16))}
    return ModelDef(model_id=model_id, weights_bytes=int(mb * 1e6),
                    exec_latency=lat)


def seed_profiles(models: Dict[str, ModelDef],
                  host_to_dev_bw: float) -> dict:
    out = {}
    for mid, md in models.items():
        for (t, b), d in md.exec_latency.items():
            out[(t, mid, b)] = d
        out[("LOAD", mid, 1)] = 1e-3 + md.weights_bytes / host_to_dev_bw
    return out


def make_sim_worker(i: int, loop: EventLoop, models: Dict[str, ModelDef], *,
                    gpus_per_worker: int, device_memory: float,
                    host_to_dev_bw: float, noise: float, spike_prob: float,
                    spike_scale: float, seed: int) -> Worker:
    """One simulated worker, identically constructed whether it lives
    in-process or behind the distributed runtime's loopback transport
    (the decision-equivalence tests depend on both builders agreeing)."""
    backend = SimBackend(host_to_dev_bw=host_to_dev_bw, noise=noise,
                         spike_prob=spike_prob, spike_scale=spike_scale,
                         seed=seed + i)
    return Worker(f"w{i}", loop, backend, models, n_gpus=gpus_per_worker,
                  device_memory_bytes=device_memory)


def place_preload(controller, workers: List[Worker],
                  models: Dict[str, ModelDef],
                  preload: Optional[List[str]]) -> None:
    """Round-robin warm placement before time starts: weights land in the
    worker pagecaches AND the controller mirrors (which must already be
    registered)."""
    if not preload:
        return
    gpu_list = [(w, g) for w in workers for g in range(w.n_gpus)]
    for j, mid in enumerate(preload):
        w, g = gpu_list[j % len(gpu_list)]
        md = models[mid]
        pages = md.pages(w.pagecaches[g].page_bytes)
        if w.pagecaches[g].alloc(mid, pages):
            mirr = controller.workers[w.worker_id].gpus[g]
            mirr.pagecache.alloc(mid, pages)


@dataclasses.dataclass
class Cluster:
    loop: EventLoop
    controller: Controller
    workers: List[Worker]
    models: Dict[str, ModelDef]
    clients: list = dataclasses.field(default_factory=list)
    # set when the cluster runs over the distributed runtime (loopback
    # transport): holds the ControllerServer/WorkerHosts/links and a
    # graceful shutdown() that flushes daemon telemetry
    runtime: Optional[object] = None

    def submit(self, req: Request):
        self.controller.on_request(req)

    def shutdown(self):
        """Gracefully wind down distributed plumbing (no-op in-process)."""
        if self.runtime is not None:
            self.runtime.shutdown()

    def attach_clients(self, clients):
        self.clients.extend(clients)
        existing = self.controller.on_response
        # bind the responder methods once — at thousands of clients the
        # per-response hasattr sweep was a simulator hot path
        responders = [c.on_response for c in self.clients
                      if hasattr(c, "on_response")]

        def fan(req):
            if existing:
                existing(req)
            for r in responders:
                r(req)

        self.controller.on_response = fan

    def run(self, t_end: float):
        self.loop.run_until(t_end)
        return self.controller.summary()

    # --------------------------------------------------------- telemetry
    @property
    def recorder(self) -> Recorder:
        return self.controller.recorder

    def telemetry_report(self) -> dict:
        """Latency breakdown + prediction-error + control-plane report for
        this run (scheduler tick-latency gauges, event-loop throughput)."""
        rep = self.controller.telemetry_report()
        rep["event_loop"] = self.loop.stats()
        return rep

    def export_profile_store(self) -> ProfileStore:
        """Fold this run's telemetry into a fresh ProfileStore (the
        shutdown-time persistence hook). Recorder records only — the
        ActionProfiler's windows hold the same durations and would be
        double-counted."""
        store = ProfileStore()
        store.update_from_recorder(self.recorder)
        return store


def build_cluster(models: Dict[str, ModelDef], *, n_workers: int = 1,
                  gpus_per_worker: int = 1, scheduler=None,
                  device_memory: float = 32e9, host_to_dev_bw: float = 12.3e9,
                  noise: float = 0.0003, spike_prob: float = 0.0,
                  spike_scale: float = 5.0,
                  action_delay: float = 0.0005, seed: int = 0,
                  preload: Optional[List[str]] = None,
                  profile_store: Optional[ProfileStore] = None,
                  recorder: Optional[Recorder] = None,
                  transport: Optional[str] = None,
                  **transport_kw) -> Cluster:
    if transport is not None:
        # route controller<->worker traffic through the distributed
        # runtime's wire protocol instead of direct calls (DESIGN.md §5);
        # transport_kw: latency/jitter/drop/transport_seed/...
        if transport != "loopback":
            raise ValueError(f"unknown transport {transport!r}; "
                             "multi-process runs use repro.runtime directly")
        from repro_torch.runtime.harness import build_loopback_cluster
        return build_loopback_cluster(
            models, n_workers=n_workers, gpus_per_worker=gpus_per_worker,
            scheduler=scheduler, device_memory=device_memory,
            host_to_dev_bw=host_to_dev_bw, noise=noise,
            spike_prob=spike_prob, spike_scale=spike_scale,
            action_delay=action_delay, seed=seed, preload=preload,
            profile_store=profile_store, recorder=recorder, **transport_kw)
    loop = EventLoop(VirtualClock())
    sched = scheduler if scheduler is not None else ClockworkScheduler()
    workers = []
    controller = Controller(loop, models, sched, action_delay=action_delay,
                            recorder=recorder)
    # persisted profiles win over the synthetic ground-truth-derived seeds
    profiles = profile_store.seed_dict() if profile_store is not None \
        else seed_profiles(models, host_to_dev_bw)
    for i in range(n_workers):
        w = make_sim_worker(i, loop, models,
                            gpus_per_worker=gpus_per_worker,
                            device_memory=device_memory,
                            host_to_dev_bw=host_to_dev_bw, noise=noise,
                            spike_prob=spike_prob,
                            spike_scale=spike_scale, seed=seed)
        workers.append(w)
        controller.add_worker(w, profiles if i == 0 else None)
    place_preload(controller, workers, models, preload)
    return Cluster(loop=loop, controller=controller, workers=workers,
                   models=models)


class TimeSeries:
    """Windowed goodput/latency sampler for figure benchmarks."""

    def __init__(self, cluster: Cluster, dt: float = 1.0):
        self.cluster = cluster
        self.dt = dt
        self.samples = []
        self._last_counts = dict(cluster.controller.stats)
        self._window_lat: List[float] = []
        base = cluster.controller.on_response

        def hook(req):
            if base:
                base(req)
            if req.status == "ok":
                self._window_lat.append(req.completion - req.arrival)

        cluster.controller.on_response = hook
        cluster.loop.schedule(dt, self._sample)

    def _sample(self):
        c = self.cluster.controller
        now = self.cluster.loop.now()
        cur = dict(c.stats)
        lat = sorted(self._window_lat)

        def pct(q):
            return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else None

        self.samples.append({
            "t": now,
            "goodput_rs": (cur["goodput"]
                           - self._last_counts["goodput"]) / self.dt,
            "timeout_rs": (cur["timeout"]
                           - self._last_counts["timeout"]) / self.dt,
            "rejected_rs": (cur["rejected"]
                            - self._last_counts["rejected"]) / self.dt,
            "p50": pct(0.50), "p99": pct(0.99), "max": pct(1.0),
        })
        self._last_counts = cur
        self._window_lat = []
        self.cluster.loop.schedule(now + self.dt, self._sample)
