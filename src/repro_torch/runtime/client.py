"""Remote request clients: the third tier of the paper's topology.

`RemoteClient` speaks SUBMIT/RESPONSE over any `Channel` (deterministic
loopback in tests and the harness, TCP in the load-generator process).
It is deliberately the same shape as the in-process submission path —
`submit(Request)` in, workload-generator `on_response` callbacks out —
so the generators in `serving/workload.py` drive a remote controller
unchanged, and a zero-latency loopback run is event-for-event identical
to `Cluster.attach_clients`.

Client-side observability: every request gets send/receive stamps on the
*client's* clock and a RequestSpan in a local `Recorder` (arrival,
queued=send, response=receive). The RESPONSE echoes the controller-side
[admission, completion] interval, which `Recorder.span_remote` stamps
onto the span — both remote stamps share the controller clock, so the
span's `net_overhead` (client-observed minus controller-observed
latency) is immune to clock skew. `report()` summarizes through
`telemetry.reports.client_breakdown`; this is the latency the paper's §6
evaluation actually measures — SLO attainment on the *client's* side of
the network.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.actions import Request
from repro_torch.core.clock import EventLoop
from repro_torch.runtime import protocol
from repro_torch.runtime.transport import Channel
from repro_torch.telemetry.recorder import Recorder
from repro_torch.telemetry.reports import client_breakdown, quantile


class RemoteClient:
    """One SUBMIT/RESPONSE connection to a remote controller."""

    def __init__(self, loop: EventLoop, channel: Channel, *,
                 recorder: Optional[Recorder] = None):
        self.loop = loop
        self.channel = channel
        self.recorder = recorder if recorder is not None else Recorder()
        # client request id -> send stamp (client clock)
        self._pending: Dict[int, float] = {}
        self._responders: List[Callable[[Request], None]] = []
        self.sent = 0
        self.lost = 0                   # in flight when the channel died
        self.stats = {"ok": 0, "timeout": 0, "rejected": 0}
        self.latencies: List[float] = []    # client-observed, ok only
        self.closed = False
        channel.on_message = self._on_message
        channel.on_close = self._on_close

    # ----------------------------------------------------------- submit
    def submit(self, req: Request) -> None:
        """Send one request; correlation is by the request's own id (the
        controller re-issues ids internally but echoes ours back)."""
        if self.closed:
            return
        t = self.loop.now()
        self._pending[req.id] = t
        self.recorder.span_open(req, queued=t)
        self.sent += 1
        self.channel.send(protocol.submit_msg(req))

    def attach(self, clients) -> None:
        """Register workload generators: anything with `on_response(req)`
        is called for every RESPONSE — mirror of Cluster.attach_clients,
        so closed-loop clients self-clock against the remote controller."""
        self._responders.extend(c.on_response for c in clients
                                if hasattr(c, "on_response"))

    # --------------------------------------------------------- inbound
    def _on_message(self, msg: dict) -> None:
        if msg.get("kind") != "response":
            return                      # forward compatibility within v1
        resp = protocol.request_from_wire(msg["request"])
        t_recv = self.loop.now()
        t_sent = self._pending.pop(resp.id, None)
        if t_sent is None:
            return                      # duplicate or post-close response
        status = resp.status or "rejected"
        self.stats[status] = self.stats.get(status, 0) + 1
        if status == "ok":
            self.latencies.append(t_recv - t_sent)
        # stitch: the echoed controller-side interval, then close the span
        self.recorder.span_remote(resp.id, resp.arrival, resp.completion)
        self.recorder.span_close(resp, t_recv)
        for r in self._responders:
            r(resp)

    def _on_close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.lost += len(self._pending)
        self._pending.clear()

    def close(self) -> None:
        """Hang up. The controller reclaims our in-flight bookkeeping on
        the channel-close callback (no leak, no send into a closed pipe)."""
        if not self.closed:
            self.channel.close()
            self._on_close()

    # --------------------------------------------------------- reporting
    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def summary(self) -> dict:
        """Client-observed counters + latency percentiles (seconds)."""
        return {"sent": self.sent, "goodput": self.stats["ok"],
                "timeout": self.stats["timeout"],
                "rejected": self.stats["rejected"],
                "in_flight": self.in_flight, "lost": self.lost,
                "p50": quantile(self.latencies, 0.50),
                "p99": quantile(self.latencies, 0.99)}

    def report(self) -> dict:
        """Span-level breakdown: client-observed vs controller-observed
        latency and the per-request network overhead between them."""
        return client_breakdown(self.recorder.iter_spans())
