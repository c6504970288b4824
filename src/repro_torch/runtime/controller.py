"""Controller-side distributed runtime: membership + remote worker stubs.

`ControllerServer` adopts transport channels (loopback or TCP) and speaks
the protocol's membership handshake. A registering worker daemon becomes a
`RemoteWorkerStub` — an object that looks exactly like a core `Worker` to
the unmodified `Controller` (worker_id, pagecache geometry, `receive`,
`ping`, `on_result`), so the controller's mirrors, scheduler, heartbeats,
and missed-result detector all work unchanged across the process boundary.

Per-worker network latency: every heartbeat PONG carries the PING's send
stamp back, the server computes the RTT and folds RTT/2 into the worker
mirror's `net_delay` (EWMA, `Controller.observe_net_delay`), which widens
the scheduler's expected-start and missed-result windows for that worker —
the paper's §5 treatment of network delay. The loopback harness disables
estimation (`estimate_net_delay=False`) and folds its *configured* latency
instead, keeping virtual-clock runs deterministic.

Channels whose first message is SUBMIT instead of HELLO are request
clients: decoded Requests enter `Controller.on_request` and their
completions return as RESPONSE frames. Client channels are tracked with
their in-flight request ids so a disconnect reclaims everything: the ids
are purged from `_req_origin` and responses for a departed client are
dropped instead of sent into a closed pipe.

Hardening: every frame handler runs behind `_frame_handler`, which turns
a `ProtocolError` (bad version, malformed frame) or a codec-level
KeyError/ValueError/TypeError into a logged close of the *offending
channel* — a garbage frame from one peer must never crash the shared
controller event loop.
"""
from __future__ import annotations

import itertools
import logging
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.actions import Request
from repro_torch.core.controller import Controller
from repro_torch.runtime import protocol
from repro_torch.runtime.transport import Channel, TcpServer

log = logging.getLogger("repro_torch.runtime")


class _PageSpec:
    """Minimal pagecache geometry stand-in (what WorkerMirror reads)."""

    __slots__ = ("total_pages", "page_bytes")

    def __init__(self, total_pages: int, page_bytes: int):
        self.total_pages = total_pages
        self.page_bytes = page_bytes


class RemoteWorkerStub:
    """Controller-side proxy for a worker daemon reachable over a Channel.

    Duck-types the parts of `core.worker.Worker` the Controller touches.
    """

    def __init__(self, channel: Channel, worker_id: str,
                 gpu_specs: List[dict], server: "ControllerServer"):
        self.channel = channel
        self.worker_id = worker_id
        self.pagecaches = [_PageSpec(g["total_pages"], g["page_bytes"])
                           for g in gpu_specs]
        self.server = server
        self.alive = True
        self.graceful = False           # set before an expected disconnect
        self.on_result: Optional[Callable] = None   # set by add_worker
        self._ping_seq = itertools.count()
        self._pings: Dict[int, tuple] = {}   # seq -> (reply, t_sent)

    # ------------------------------------------------- Worker-facing API
    def receive(self, action) -> None:
        if self.alive:
            self.channel.send(protocol.action_msg(action))

    def ping(self, reply: Callable[[], None]) -> None:
        if not self.alive:
            return
        seq = next(self._ping_seq)
        t = self.server.controller.loop.now()
        self._pings[seq] = (reply, t)
        self.channel.send(protocol.ping(seq, t))

    # ---------------------------------------------------- frame handling
    def handle(self, msg: dict) -> None:
        # wire decoding goes through protocol.field/decode, which turn
        # structural garbage into ProtocolError for the server's frame
        # guard; the controller calls that follow run unguarded, so an
        # internal bug still fails loudly instead of being misread as a
        # bad frame from this worker
        kind = msg.get("kind")
        c = self.server.controller
        if kind == "result":
            r = protocol.decode(protocol.result_from_wire,
                                protocol.field(msg, "result"))
            if self.on_result is not None:
                self.on_result(r)
        elif kind == "pong":
            seq = protocol.field(msg, "seq")
            if isinstance(seq, (dict, list)):
                raise protocol.ProtocolError("pong seq is unhashable")
            entry = self._pings.pop(seq, None)
            if entry is None:
                return
            reply, t_sent = entry
            if self.server.estimate_net_delay:
                # the PONG echoes the worker's reply turnaround (`hold`):
                # subtracting it leaves the pure network round-trip, so a
                # slow-to-answer worker no longer inflates its net_delay
                hold = protocol.decode(float, msg.get("hold", 0.0))
                rtt = max(0.0, c.loop.now() - t_sent - hold)
                c.observe_net_delay(self.worker_id, rtt)
            reply()
        elif kind == "telemetry":
            rec = c.recorder
            for wire in protocol.decode(tuple, msg.get("gauges", ())):
                g = protocol.decode(protocol.gauge_from_wire, wire)
                rec.record_gauge(g.name, g.t, g.value)
        elif kind == "sync":
            self.channel.send(protocol.sync_ack(protocol.field(msg, "t0"),
                                                c.loop.now()))
        elif kind == "goodbye":
            self.graceful = True
            self.alive = False
            self.channel.send(protocol.goodbye_ack())
            c.remove_worker(self.worker_id)
        # unknown kinds are ignored (forward compatibility within v1)

    def handle_close(self) -> None:
        was_alive = self.alive
        self.alive = False
        if was_alive and not self.graceful:
            self.server.controller.worker_failed(self.worker_id)


class ControllerServer:
    """Adopts channels, runs the membership handshake, and owns the
    controller-side ends of all worker/client connections."""

    def __init__(self, controller: Controller, *,
                 estimate_net_delay: bool = True):
        self.controller = controller
        self.estimate_net_delay = estimate_net_delay
        self.stubs: Dict[str, RemoteWorkerStub] = {}
        # client channel -> its in-flight local request ids; removed (with
        # the ids purged from _req_origin) when the channel closes
        self.clients: Dict[Channel, Set[int]] = {}
        # local request id -> (origin channel, the client's own id)
        self._req_origin: Dict[int, tuple] = {}
        self._tcp: Optional[TcpServer] = None
        self.closed = False
        self.bad_frames = 0          # channels closed on malformed input

        prev = controller.on_response

        def fan(req):
            if prev:
                prev(req)
            origin = self._req_origin.pop(req.id, None)
            if origin is not None:
                ch, remote_id = origin
                inflight = self.clients.get(ch)
                if inflight is None:
                    return           # client left; drop, don't send
                inflight.discard(req.id)
                ch.send(protocol.response_msg(req, override_id=remote_id))

        controller.on_response = fan

    # ------------------------------------------------------- channel intake
    def _frame_handler(self, channel: Channel,
                       fn: Callable[[dict], None]) -> Callable[[dict], None]:
        """Wrap a per-frame handler so malformed input closes the offending
        channel instead of raising into the shared event loop. Handlers
        funnel all wire decoding through protocol.field/decode, so only
        ProtocolError means "bad frame" — an internal controller bug still
        propagates loudly rather than being pinned on an innocent peer."""
        def handle(msg: dict) -> None:
            try:
                fn(msg)
            except protocol.ProtocolError as e:
                self.bad_frames += 1
                log.warning("closing channel after bad frame "
                            "(kind=%r): %s", msg.get("kind"), e)
                channel.close()
        return handle

    def adopt(self, channel: Channel) -> None:
        """Take ownership of a fresh channel; the first frame decides
        whether it is a worker (HELLO) or a request client (SUBMIT)."""
        channel.on_message = self._frame_handler(
            channel, lambda msg: self._first_frame(channel, msg))
        channel.on_close = lambda: None

    def _first_frame(self, channel: Channel, msg: dict) -> None:
        protocol.check_version(msg)
        kind = msg.get("kind")
        if kind == "hello":
            self._register_worker(channel, msg)
        elif kind == "submit":
            self.clients[channel] = set()
            channel.on_message = self._frame_handler(
                channel, lambda m: self._client_frame(channel, m))
            channel.on_close = lambda: self._client_closed(channel)
            self._client_frame(channel, msg)
        else:
            channel.close()

    def _register_worker(self, channel: Channel, msg: dict) -> None:
        # decode/validate the whole HELLO before touching controller state
        wid = protocol.decode(str, protocol.field(msg, "worker_id"))
        gpu_specs = protocol.decode(protocol.gpus_from_hello, msg)
        profiles = protocol.decode(protocol.profiles_from_hello, msg)
        if wid in self.controller.workers:
            # a stale registration (daemon restart): retire the old mirror
            # gracefully — outstanding work is requeued, but a planned
            # replacement must not count as a dead worker
            old = self.stubs.get(wid)
            if old is not None:
                old.graceful = True
                old.alive = False
                old.channel.close()
            self.controller.remove_worker(wid)
        stub = RemoteWorkerStub(channel, wid, gpu_specs, self)
        self.stubs[wid] = stub
        channel.on_message = self._frame_handler(channel, stub.handle)
        channel.on_close = stub.handle_close
        self.controller.add_worker(stub, profiles)
        channel.send(protocol.welcome(
            wid, self.controller.heartbeat_interval))

    def _client_frame(self, channel: Channel, msg: dict) -> None:
        if msg.get("kind") == "submit":
            wire = protocol.decode(protocol.request_from_wire,
                                   protocol.field(msg, "request"))
            if wire.model_id not in self.controller.models:
                # unknown model: reject on the spot — the name must never
                # enter the scheduler (its queues are a defaultdict, and a
                # bogus key would only blow up later, outside the guard)
                wire.status = "rejected"
                wire.completion = self.controller.loop.now()
                channel.send(protocol.response_msg(wire))
                return
            # re-issue the id: client-process id counters collide with each
            # other and with controller-local requests. The remote arrival
            # stamp is likewise meaningless on this clock — admission time
            # is the arrival. The RESPONSE echoes the client's own id back.
            req = Request(model_id=wire.model_id,
                          arrival=self.controller.loop.now(),
                          slo=wire.slo, batchable=wire.batchable)
            self._req_origin[req.id] = (channel, wire.id)
            self.clients[channel].add(req.id)
            self.controller.on_request(req)

    def _client_closed(self, channel: Channel) -> None:
        """Reclaim a departed client: requests still in flight keep being
        served (the scheduler already committed to them) but their origin
        entries go away, so completions are counted and dropped rather
        than sent into a closed channel."""
        inflight = self.clients.pop(channel, None)
        if inflight:
            for rid in inflight:
                self._req_origin.pop(rid, None)

    # -------------------------------------------------------------- TCP
    def listen_tcp(self, host: str, port: int,
                   post: Callable[[Callable[[], None]], None]) -> int:
        """Start accepting worker/client connections; returns bound port."""
        self._tcp = TcpServer(host, port, post, self.adopt)
        return self._tcp.port

    # --------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        """Graceful stop: tell every live daemon to wind down (they flush
        telemetry and exit), then stop accepting."""
        if self.closed:
            return
        self.closed = True
        for stub in self.stubs.values():
            if stub.alive:
                stub.graceful = True
                stub.channel.send(protocol.goodbye("controller shutdown"))
        if self._tcp is not None:
            # keep live channels open: daemons flush telemetry, ack, and
            # hang up themselves; we only stop accepting new ones
            self._tcp.close(close_channels=False)
