"""Pluggable transports for the distributed runtime (DESIGN.md §5).

A `Channel` is one endpoint of a bidirectional, ordered message pipe:
`send(msg)` ships a protocol dict; incoming messages arrive via the
`on_message` callback, connection teardown via `on_close`. Two
implementations:

* `LoopbackLink` — an in-process pair of channels wired through the
  shared EventLoop. Every message still round-trips through the real
  frame codec (encode -> bytes -> decode), so the wire format is
  exercised, but delivery is deterministic: with zero configured
  latency/jitter/drop, delivery is synchronous inside the sender's event,
  which makes the event sequence *identical* to the in-process path (the
  decision-equivalence tests rely on this). With latency/jitter/drop
  configured, delivery is scheduled on the loop with a seeded RNG —
  virtual-clock compatible and reproducible. FIFO order is preserved per
  direction even under jitter (a real TCP stream never reorders).

* `TcpChannel`/`TcpServer` — a real socket transport for multi-process
  runs. Reader threads never touch the event loop: they `post()` decoded
  messages through a `RealtimePump` (core/clock.py) onto the loop thread.
"""
from __future__ import annotations

import random
import socket
import threading
from typing import Callable, List, Optional

from repro_torch.runtime.protocol import FrameDecoder, ProtocolError, encode_frame

# frame kinds eligible for loopback drop injection: losing serving traffic
# exercises the missed-result detector; losing membership/liveness frames
# would just wedge the handshake, which isn't the failure mode under test
DROPPABLE_KINDS = ("action", "result")


class Channel:
    """One endpoint of an ordered message pipe."""

    def __init__(self):
        self.on_message: Optional[Callable[[dict], None]] = None
        self.on_close: Optional[Callable[[], None]] = None

    def send(self, msg: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------- loopback
class _LoopbackEndpoint(Channel):
    def __init__(self, link: "LoopbackLink", side: int):
        super().__init__()
        self._link = link
        self._side = side

    def send(self, msg: dict) -> None:
        self._link._send(self._side, msg)

    def close(self) -> None:
        self._link.close()


class LoopbackLink:
    """Deterministic in-process channel pair over a shared EventLoop.

    latency: fixed one-way delay (seconds); jitter: extra uniform [0, j)
    delay per frame; drop: per-frame drop probability (serving frames
    only, see DROPPABLE_KINDS). All randomness comes from one seeded RNG,
    so runs are bit-reproducible under the virtual clock.
    """

    def __init__(self, loop, *, latency: float = 0.0, jitter: float = 0.0,
                 drop: float = 0.0, seed: int = 0):
        self.loop = loop
        self.latency = latency
        self.jitter = jitter
        self.drop = drop
        self.rng = random.Random(seed)
        self.a = _LoopbackEndpoint(self, 0)   # controller-side by convention
        self.b = _LoopbackEndpoint(self, 1)   # worker-side by convention
        self._peer = {0: self.b, 1: self.a}
        # per-direction FIFO floor: delivery never before the previous frame
        self._fifo_floor = [0.0, 0.0]
        self.closed = False
        self.dropped = 0
        self.frames = 0

    def _send(self, side: int, msg: dict) -> None:
        if self.closed:
            return
        # full codec round-trip: the loopback path must exercise exactly
        # the bytes the TCP path would carry
        frames = FrameDecoder().feed(encode_frame(msg))
        if len(frames) != 1:
            raise ProtocolError("loopback frame did not round-trip")
        decoded = frames[0]
        self.frames += 1
        if self.drop and decoded.get("kind") in DROPPABLE_KINDS \
                and self.rng.random() < self.drop:
            self.dropped += 1
            return
        peer = self._peer[side]

        def deliver(msg=decoded, peer=peer):
            if not self.closed and peer.on_message is not None:
                peer.on_message(msg)

        delay = self.latency
        if self.jitter:
            delay += self.jitter * self.rng.random()
        if delay <= 0.0:
            deliver()                 # synchronous: event-sequence neutral
            return
        at = max(self.loop.now() + delay, self._fifo_floor[side])
        self._fifo_floor[side] = at
        self.loop.schedule(at, deliver)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for ep in (self.a, self.b):
            if ep.on_close is not None:
                ep.on_close()


# --------------------------------------------------------------------- TCP
class TcpChannel(Channel):
    """Channel over a connected socket. A reader thread decodes frames and
    posts them (via `post`, typically RealtimePump.post) onto the event
    loop thread; send() writes synchronously under a lock."""

    def __init__(self, sock: socket.socket,
                 post: Callable[[Callable[[], None]], None]):
        super().__init__()
        self._sock = sock
        self._post = post
        self._wlock = threading.Lock()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        dec = FrameDecoder()
        try:
            while True:
                data = self._sock.recv(65536)
                if not data:
                    break
                for msg in dec.feed(data):
                    self._post(lambda m=msg: self._dispatch(m))
        except (OSError, ProtocolError):
            pass
        self._post(self._dispatch_close)

    def _dispatch(self, msg: dict) -> None:
        if not self._closed and self.on_message is not None:
            self.on_message(msg)

    def _dispatch_close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.on_close is not None:
            self.on_close()

    def send(self, msg: dict) -> None:
        if self._closed:
            return
        data = encode_frame(msg)
        try:
            with self._wlock:
                self._sock.sendall(data)
        except OSError:
            self._dispatch_close()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def tcp_connect(host: str, port: int,
                post: Callable[[Callable[[], None]], None],
                timeout: float = 10.0) -> TcpChannel:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    ch = TcpChannel(sock, post)
    ch.start()
    return ch


class TcpServer:
    """Listening socket; each accepted connection becomes a TcpChannel
    handed to `on_channel` on the loop thread."""

    def __init__(self, host: str, port: int,
                 post: Callable[[Callable[[], None]], None],
                 on_channel: Callable[[TcpChannel], None]):
        self._post = post
        self._on_channel = on_channel
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self.channels: List[TcpChannel] = []
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ch = TcpChannel(conn, self._post)
            self.channels.append(ch)

            def adopt(ch=ch):
                self._on_channel(ch)
                ch.start()

            self._post(adopt)

    def close(self, close_channels: bool = True) -> None:
        """Stop accepting. `close_channels=False` leaves live connections
        open — a graceful shutdown wants peers to flush and hang up
        themselves, not to have their final frames torn down."""
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        if close_channels:
            for ch in self.channels:
                ch.close()
