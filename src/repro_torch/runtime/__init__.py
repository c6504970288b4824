"""Distributed serving runtime (DESIGN.md §5).

Lifts the in-process Controller/Worker pair across a process boundary:

* `protocol`  — versioned, length-prefixed JSON wire protocol for
  Request/Action/Result/telemetry traffic plus membership messages.
* `transport` — pluggable Channel abstraction with a deterministic
  in-process loopback (injectable latency/jitter/drop, virtual-clock
  compatible) and a real TCP implementation for multi-process runs.
* `controller` — ControllerServer: worker membership (join/leave,
  heartbeats feeding the missed-result detector) and per-worker network
  latency estimation folded into the scheduler's action windows.
* `worker` — WorkerHost/WorkerDaemon (`python -m repro_torch.runtime.worker`):
  registers with the controller, executes actions via the existing core
  Worker + backends, and streams results + telemetry back.
* `client` — RemoteClient: the SUBMIT/RESPONSE request client with
  client-side send/receive stamps, per-request latency spans in a local
  Recorder, and skew-free network-overhead stitching from the RESPONSE's
  echoed controller stamps.
* `loadgen` — the load-generator process (`python -m
  repro_torch.runtime.loadgen`): drives the seeded serving/workload generators
  through RemoteClients over TCP (optionally multi-process) and reports
  client-observed goodput + latency percentiles — the third tier of the
  paper's topology.
* `harness` — builds loopback "distributed" clusters that plug into the
  existing simulator Cluster API (plus `attach_remote_client` for the
  client tier on the virtual clock), and demo model sets shared by both
  sides of the TCP demo.
"""
from repro_torch.runtime.protocol import PROTOCOL_VERSION  # noqa: F401
