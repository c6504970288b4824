"""Worker-side distributed runtime: WorkerHost bridge + WorkerDaemon CLI.

`WorkerHost` wraps an existing `core.worker.Worker` (with any backend —
SimBackend or the real JAX engine runners) and bridges it over a Channel:

* ACTION frames are decoded and their `[earliest, latest]` windows mapped
  from the controller's clock into the local clock (`ClockSync`) before
  entering the worker's executors — so window enforcement still means what
  the controller intended despite clock skew;
* local Results get their timestamps mapped *back* onto the controller's
  timeline before the RESULT frame is sent — cross-boundary span
  stitching: the controller's RequestSpans and ActionRecords carry
  worker-side stamps on one consistent clock;
* PING is answered like the in-process `Worker.ping` (after
  `result_delay`, only while alive), so heartbeat semantics match;
* worker-side telemetry (per-executor busy-seconds and queue depth, clock
  offset) is sampled periodically into a buffer and flushed as TELEMETRY
  frames when the buffer fills — and always on `shutdown()`, so a
  daemon's final samples are never lost (`telemetry_report` counts match
  single-process runs).

`python -m repro_torch.runtime.worker --controller HOST:PORT ...` runs the
daemon: a RealClock EventLoop + RealtimePump, a SimBackend-backed Worker
over the Table-1 demo model set, and a TCP channel to the controller.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
from typing import List, Optional

from repro_torch.core.clock import EventLoop, RealClock, RealtimePump
from repro_torch.core.worker import Worker
from repro_torch.runtime import protocol
from repro_torch.runtime.transport import Channel, tcp_connect
from repro_torch.telemetry.events import GaugeSample
from repro_torch.telemetry.recorder import Recorder


class ClockSync:
    """Cristian-style offset estimation between this process's loop clock
    and the controller's: `remote ≈ local + offset`. The minimum-RTT
    exchange wins (least queueing distortion). With no observations the
    sync is the identity — exactly right for loopback channels that share
    one clock."""

    def __init__(self):
        self.offset = 0.0
        self.best_rtt = float("inf")
        self.samples = 0

    def observe(self, t0_local: float, t_remote: float,
                t1_local: float) -> float:
        rtt = max(0.0, t1_local - t0_local)
        self.samples += 1
        if rtt <= self.best_rtt:
            self.best_rtt = rtt
            self.offset = t_remote + rtt / 2.0 - t1_local
        return rtt

    def to_remote(self, t_local: float) -> float:
        return t_local + self.offset

    def to_local(self, t_remote: float) -> float:
        return t_remote - self.offset


class WorkerHost:
    """Daemon-side bridge between a core Worker and a Channel."""

    def __init__(self, worker: Worker, channel: Channel, *,
                 profiles: Optional[dict] = None,
                 sync_interval: Optional[float] = None,
                 telemetry_interval: Optional[float] = 1.0,
                 telemetry_batch: int = 16,
                 recorder: Optional[Recorder] = None,
                 on_shutdown=None):
        self.worker = worker
        self.loop = worker.loop
        self.channel = channel
        self.sync = ClockSync()
        self.sync_interval = sync_interval
        self.telemetry_interval = telemetry_interval
        self.telemetry_batch = telemetry_batch
        self.recorder = recorder        # optional local (streaming) sink
        self.on_shutdown = on_shutdown  # called once fully closed
        self._profiles = profiles
        self._pending: List[GaugeSample] = []
        self.registered = False
        self.closed = False
        self._goodbye_sent = False
        self.telemetry_flushes = 0
        worker.on_result = self._on_local_result
        channel.on_message = self._on_message
        channel.on_close = self._on_channel_close

    # ------------------------------------------------------ registration
    def register(self) -> None:
        spec = self.worker.spec()
        self.channel.send(protocol.hello(spec["worker_id"], spec["gpus"],
                                         self._profiles))
        if self.sync_interval:
            self._sync_tick()
        if self.telemetry_interval:
            self.loop.schedule_in(self.telemetry_interval,
                                  self._telemetry_tick)

    # ------------------------------------------------------- clock sync
    def _sync_tick(self) -> None:
        if self.closed:
            return
        self.channel.send(protocol.sync(self.loop.now()))
        self.loop.schedule_in(self.sync_interval, self._sync_tick)

    # ---------------------------------------------------------- inbound
    def _on_message(self, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "action":
            a = protocol.action_from_wire(msg["action"])
            a.earliest = self.sync.to_local(a.earliest)
            a.latest = self.sync.to_local(a.latest)
            self.worker.receive(a)
        elif kind == "ping":
            if self.worker.alive:
                t_recv = self.loop.now()

                def reply(seq=msg["seq"], t_sent=msg["t_sent"],
                          t_recv=t_recv):
                    # echo the actual turnaround so the controller's RTT
                    # measurement excludes our reply delay
                    hold = self.loop.now() - t_recv
                    self.channel.send(protocol.pong(seq, t_sent, hold))

                self.loop.schedule_in(self.worker.result_delay, reply)
        elif kind == "sync_ack":
            self.sync.observe(msg["t0"], msg["t_remote"], self.loop.now())
        elif kind == "welcome":
            protocol.check_version(msg)
            self.registered = True
        elif kind == "goodbye":
            # controller-initiated wind-down: flush, ack, stop — but leave
            # the pipe open: the flush/ack frames may still be in flight
            # (loopback latency schedules them; TCP buffers them) and
            # closing here would tear them down. The transport closes when
            # the process exits / the peer hangs up.
            self.flush_telemetry(sample_first=True)
            self.channel.send(protocol.goodbye_ack())
            self.closed = True
            if self.on_shutdown is not None:
                self.on_shutdown()
        elif kind == "goodbye_ack":
            self._finish_close()

    # --------------------------------------------------------- outbound
    def _on_local_result(self, r) -> None:
        if self.closed:
            return
        to_r = self.sync.to_remote
        wire = dataclasses.replace(
            r, t_start=to_r(r.t_start), t_end=to_r(r.t_end),
            t_received=to_r(r.t_received))
        self.channel.send(protocol.result_msg(wire))

    # -------------------------------------------------------- telemetry
    def _telemetry_tick(self) -> None:
        if self.closed:
            return
        self.sample_telemetry()
        if len(self._pending) >= self.telemetry_batch:
            self.flush_telemetry()
        self.loop.schedule_in(self.telemetry_interval, self._telemetry_tick)

    def sample_telemetry(self) -> None:
        """Append one round of worker-side gauges (controller timeline)."""
        now_r = self.sync.to_remote(self.loop.now())
        wid = self.worker.worker_id
        add = self._pending.append
        for (g, lane), ex in self.worker.execs.items():
            add(GaugeSample(name=f"worker/{wid}/gpu{g}/{lane}/busy_s",
                            t=now_r, value=ex.total_busy))
            add(GaugeSample(name=f"worker/{wid}/gpu{g}/{lane}/queue_depth",
                            t=now_r, value=float(len(ex.q))))
        add(GaugeSample(name=f"worker/{wid}/clock_offset_s", t=now_r,
                        value=self.sync.offset))

    def flush_telemetry(self, sample_first: bool = False) -> None:
        """Ship buffered gauges. Called when the buffer fills and — the
        part long-running daemons rely on — unconditionally at shutdown,
        so in-flight telemetry is never dropped."""
        if sample_first:
            self.sample_telemetry()
        if self.closed or not self._pending:
            return
        if self.recorder is not None:
            for g in self._pending:
                self.recorder.record_gauge(g.name, g.t, g.value)
        self.channel.send(protocol.telemetry_msg(self._pending))
        self._pending = []
        self.telemetry_flushes += 1

    # --------------------------------------------------------- shutdown
    def shutdown(self, reason: str = "worker shutdown") -> None:
        """Graceful daemon-initiated leave: flush telemetry, then GOODBYE
        (the controller re-queues outstanding work and drops the mirror).
        The channel closes on GOODBYE_ACK or transport teardown."""
        if self.closed or self._goodbye_sent:
            return
        self.flush_telemetry(sample_first=True)
        self._goodbye_sent = True
        self.channel.send(protocol.goodbye(reason))

    def _finish_close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.channel.close()
        if self.on_shutdown is not None:
            self.on_shutdown()

    def _on_channel_close(self) -> None:
        if not self.closed:
            self.closed = True
            if self.on_shutdown is not None:
                self.on_shutdown()


# ----------------------------------------------------------------- daemon
def demo_models(n_models: int):
    """The Table-1-derived model set both sides of the TCP demo build —
    the daemon's ground truth and the controller's model registry must
    name the same models."""
    from repro_torch.serving.simulator import PAPER_TABLE1, table1_modeldef
    fams = list(PAPER_TABLE1)
    return {f"m{i}": table1_modeldef(f"m{i}", family=fams[i % len(fams)])
            for i in range(n_models)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.worker",
        description="Clockwork worker daemon: registers with a controller "
                    "over TCP and executes actions on the local backend.")
    p.add_argument("--controller", required=True, metavar="HOST:PORT")
    p.add_argument("--worker-id", required=True)
    p.add_argument("--n-models", type=int, default=4,
                   help="size of the shared Table-1 demo model set")
    p.add_argument("--gpus", type=int, default=1)
    p.add_argument("--memory-gb", type=float, default=32.0)
    p.add_argument("--noise", type=float, default=0.0003)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=float, default=None,
                   help="exit after this many seconds (default: run until "
                        "the controller says goodbye or SIGTERM)")
    p.add_argument("--sync-interval", type=float, default=1.0)
    p.add_argument("--telemetry-interval", type=float, default=1.0)
    p.add_argument("--no-seed-profiles", action="store_true",
                   help="do not send Table-1 seed profiles in HELLO")
    p.add_argument("--telemetry-jsonl", default=None,
                   help="stream worker-side telemetry to this JSONL file")
    p.add_argument("--rotate-bytes", type=int, default=None,
                   help="rotate the telemetry JSONL when it exceeds this")
    args = p.parse_args(argv)

    host, _, port = args.controller.rpartition(":")
    models = demo_models(args.n_models)

    from repro_torch.core.worker import SimBackend
    loop = EventLoop(RealClock())
    pump = RealtimePump(loop)
    backend = SimBackend(noise=args.noise, seed=args.seed)
    worker = Worker(args.worker_id, loop, backend, models,
                    n_gpus=args.gpus,
                    device_memory_bytes=args.memory_gb * 1e9)

    recorder = None
    if args.telemetry_jsonl:
        recorder = Recorder()
        recorder.stream_to(args.telemetry_jsonl,
                           rotate_bytes=args.rotate_bytes)

    profiles = None
    if not args.no_seed_profiles:
        from repro_torch.serving.simulator import seed_profiles
        profiles = seed_profiles(models, backend.host_to_dev_bw)

    channel = tcp_connect(host, int(port), pump.post)
    hostside = WorkerHost(worker, channel, profiles=profiles,
                          sync_interval=args.sync_interval,
                          telemetry_interval=args.telemetry_interval,
                          recorder=recorder, on_shutdown=pump.stop)

    def request_shutdown(*_sig):
        pump.post(hostside.shutdown)

    signal.signal(signal.SIGTERM, request_shutdown)
    signal.signal(signal.SIGINT, request_shutdown)

    pump.post(hostside.register)
    pump.run(until=lambda: hostside.closed, timeout=args.duration)
    if not hostside.closed:
        # duration elapsed: leave gracefully, give the ack a moment
        hostside.shutdown("duration elapsed")
        pump.run(until=lambda: hostside.closed, timeout=5.0)
    if recorder is not None:
        recorder.close_stream()
    return 0


if __name__ == "__main__":
    sys.exit(main())
