"""Versioned wire protocol for the distributed runtime (DESIGN.md §5).

Framing: every message is one frame — a 4-byte big-endian length prefix
followed by a UTF-8 JSON object. JSON keeps the protocol dependency-free
and debuggable (`nc` + eyeballs); floats round-trip exactly through
Python's repr-based encoder, which the loopback decision-equivalence
tests rely on.

Every message carries `{"v": PROTOCOL_VERSION, "kind": <str>, ...}`.
Kinds:

  membership   HELLO (worker -> controller: worker spec + optional seed
               profiles), WELCOME (ack + controller parameters), GOODBYE /
               GOODBYE_ACK (graceful leave, either direction)
  liveness     PING / PONG (controller-initiated heartbeats; PONG echoes
               the send stamp so the controller estimates per-worker RTT)
  clock sync   SYNC / SYNC_ACK (worker-initiated Cristian exchange: the
               worker maps controller-clock action windows into its local
               clock and reports result stamps back on the controller's
               timeline — cross-boundary span stitching)
  serving      ACTION (controller -> worker), RESULT (worker ->
               controller; an optional `phases` key carries the backend's
               measured breakdown), SUBMIT / RESPONSE (remote request
               clients)
  telemetry    TELEMETRY (worker -> controller: batched gauge samples,
               flushed periodically and on daemon shutdown)

Codec functions are pure dict<->dataclass mappers over the types in
`repro.core.actions` / `repro.telemetry.events`; ids are preserved, never
regenerated, so the controller's bookkeeping (outstanding actions, open
spans) works unchanged across the boundary.
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Iterator, List, Optional

from repro_torch.core.actions import Action, ActionType, Phases, Request, \
    Result, ResultStatus
from repro_torch.telemetry.events import GaugeSample

PROTOCOL_VERSION = 1
MAX_FRAME_BYTES = 16 << 20          # sanity bound against corrupt streams
_LEN = struct.Struct(">I")


class ProtocolError(Exception):
    pass


# ----------------------------------------------------------------- framing
def encode_frame(msg: dict) -> bytes:
    # allow_nan=True: best-effort requests carry slo=inf, and Python's JSON
    # Infinity extension round-trips it (both endpoints are this codec)
    body = json.dumps(msg, separators=(",", ":"), allow_nan=True) \
        .encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {len(body)} bytes")
    return _LEN.pack(len(body)) + body


class FrameDecoder:
    """Incremental frame reassembly: feed() arbitrary byte chunks, get
    complete decoded messages out (TCP gives no message boundaries)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[dict]:
        self._buf.extend(data)
        out: List[dict] = []
        buf = self._buf
        while True:
            if len(buf) < _LEN.size:
                break
            (n,) = _LEN.unpack_from(buf, 0)
            if n > MAX_FRAME_BYTES:
                raise ProtocolError(f"frame length {n} exceeds bound")
            if len(buf) < _LEN.size + n:
                break
            body = bytes(buf[_LEN.size:_LEN.size + n])
            del buf[:_LEN.size + n]
            try:
                msg = json.loads(body)
            except ValueError as e:
                raise ProtocolError(f"bad frame payload: {e}") from e
            if not isinstance(msg, dict):
                raise ProtocolError("frame payload is not an object")
            out.append(msg)
        return out


def check_version(msg: dict) -> dict:
    v = msg.get("v")
    if v != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: got {v!r}, "
            f"want {PROTOCOL_VERSION}")
    return msg


def field(msg: dict, key: str):
    """Required frame field; missing => ProtocolError (frame boundary)."""
    try:
        return msg[key]
    except (KeyError, TypeError):
        raise ProtocolError(f"frame missing field {key!r}") from None


def decode(codec, payload):
    """Run a codec over untrusted payload, converting structural errors
    into ProtocolError — so frame handlers raise exactly one exception
    type for malformed input and the server's frame-boundary guard can
    close the offending channel without also swallowing internal bugs."""
    try:
        return codec(payload)
    except (KeyError, ValueError, TypeError, IndexError,
            AttributeError) as e:
        name = getattr(codec, "__name__", "codec")
        raise ProtocolError(f"malformed payload for {name}: {e}") from e


def _msg(kind: str, **fields) -> dict:
    fields["v"] = PROTOCOL_VERSION
    fields["kind"] = kind
    return fields


# ------------------------------------------------------------------ codecs
def action_to_wire(a: Action) -> dict:
    return {"id": a.id, "type": a.type.value, "model_id": a.model_id,
            "worker_id": a.worker_id, "gpu_id": a.gpu_id,
            "earliest": a.earliest, "latest": a.latest,
            "expected_duration": a.expected_duration,
            "batch_size": a.batch_size,
            "request_ids": list(a.request_ids),
            "issued_at": a.issued_at,
            "expected_completion": a.expected_completion}


def action_from_wire(d: dict) -> Action:
    # type coercions are identity for well-formed frames (float of a
    # float, int of an int) but turn malicious values — a string where
    # arithmetic expects a number — into errors *inside* `decode`, at
    # the frame boundary, instead of deep in the controller/worker
    return Action(type=ActionType(d["type"]), model_id=str(d["model_id"]),
                  worker_id=str(d["worker_id"]), gpu_id=int(d["gpu_id"]),
                  earliest=float(d["earliest"]), latest=float(d["latest"]),
                  expected_duration=float(d["expected_duration"]),
                  batch_size=int(d.get("batch_size", 1)),
                  request_ids=tuple(int(i)
                                    for i in d.get("request_ids", ())),
                  id=int(d["id"]),
                  issued_at=float(d.get("issued_at", 0.0)),
                  expected_completion=float(
                      d.get("expected_completion", 0.0)))


def result_to_wire(r: Result) -> dict:
    d = {"action_id": r.action_id, "action_type": r.action_type.value,
         "model_id": r.model_id, "worker_id": r.worker_id,
         "gpu_id": r.gpu_id, "status": r.status.value,
         "t_start": r.t_start, "t_end": r.t_end,
         "duration": r.duration, "batch_size": r.batch_size,
         "request_ids": list(r.request_ids),
         "t_received": r.t_received}
    if r.phases is not None:        # optional: absent where none measured
        d["phases"] = dataclasses.asdict(r.phases)
    return d


def _phases_from_wire(x: Optional[dict]) -> Optional[Phases]:
    if x is None:
        return None
    device_s = x.get("device_s")
    return Phases(input_s=float(x["input_s"]), launch_s=float(x["launch_s"]),
                  wait_s=float(x["wait_s"]),
                  device_s=None if device_s is None else float(device_s))


def result_from_wire(d: dict) -> Result:
    return Result(action_id=int(d["action_id"]),
                  action_type=ActionType(d["action_type"]),
                  model_id=str(d["model_id"]), worker_id=str(d["worker_id"]),
                  gpu_id=int(d["gpu_id"]), status=ResultStatus(d["status"]),
                  t_start=float(d["t_start"]), t_end=float(d["t_end"]),
                  duration=float(d["duration"]),
                  batch_size=int(d.get("batch_size", 1)),
                  request_ids=tuple(int(i)
                                    for i in d.get("request_ids", ())),
                  t_received=float(d.get("t_received", 0.0)),
                  phases=_phases_from_wire(d.get("phases")))


def request_to_wire(r: Request) -> dict:
    return {"id": r.id, "model_id": r.model_id, "arrival": r.arrival,
            "slo": r.slo, "batchable": r.batchable,
            "completion": r.completion, "status": r.status}


def request_from_wire(d: dict) -> Request:
    completion = d.get("completion")
    status = d.get("status")
    return Request(model_id=str(d["model_id"]), arrival=float(d["arrival"]),
                   slo=float(d["slo"]), id=int(d["id"]),
                   batchable=bool(d.get("batchable", True)),
                   completion=None if completion is None
                   else float(completion),
                   status=None if status is None else str(status))


def gauge_to_wire(g: GaugeSample) -> list:
    return [g.name, g.t, g.value]


def gauge_from_wire(x: list) -> GaugeSample:
    return GaugeSample(name=str(x[0]), t=float(x[1]), value=float(x[2]))


# ------------------------------------------------------------ constructors
def hello(worker_id: str, gpus: List[dict],
          profiles: Optional[dict] = None) -> dict:
    """`profiles` maps (action_type, model_id, batch) -> seconds; sent as
    a flat list so JSON keys stay strings."""
    wire_profiles = None
    if profiles:
        wire_profiles = [[t, mid, b, d]
                         for (t, mid, b), d in profiles.items()]
    return _msg("hello", worker_id=worker_id, gpus=gpus,
                profiles=wire_profiles)


def gpus_from_hello(msg: dict) -> List[dict]:
    """Validated pagecache geometry from a HELLO (ints or it's a
    ProtocolError via `decode`)."""
    return [{"total_pages": int(g["total_pages"]),
             "page_bytes": int(g["page_bytes"])} for g in field(msg, "gpus")]


def profiles_from_hello(msg: dict) -> Optional[dict]:
    wire = msg.get("profiles")
    if not wire:
        return None
    return {(str(t), str(mid), int(b)): float(d) for t, mid, b, d in wire}


def welcome(worker_id: str, heartbeat_interval: float) -> dict:
    return _msg("welcome", worker_id=worker_id,
                heartbeat_interval=heartbeat_interval)


def ping(seq: int, t_sent: float) -> dict:
    return _msg("ping", seq=seq, t_sent=t_sent)


def pong(seq: int, t_sent: float, hold: float = 0.0) -> dict:
    """`hold` is the worker's reply turnaround (local receive -> send, in
    seconds): the controller subtracts it from the measured round-trip so
    net-delay estimates cover the network, not the worker's result_delay."""
    return _msg("pong", seq=seq, t_sent=t_sent, hold=hold)


def sync(t0: float) -> dict:
    return _msg("sync", t0=t0)


def sync_ack(t0: float, t_remote: float) -> dict:
    return _msg("sync_ack", t0=t0, t_remote=t_remote)


def action_msg(a: Action) -> dict:
    return _msg("action", action=action_to_wire(a))


def result_msg(r: Result) -> dict:
    return _msg("result", result=result_to_wire(r))


def telemetry_msg(gauges: List[GaugeSample]) -> dict:
    return _msg("telemetry", gauges=[gauge_to_wire(g) for g in gauges])


def submit_msg(r: Request) -> dict:
    return _msg("submit", request=request_to_wire(r))


def response_msg(r: Request, override_id: Optional[int] = None) -> dict:
    """`override_id` restores the client's own request id: controller-side
    ids are re-issued on SUBMIT (per-process id counters collide across
    client processes), but the client correlates by the id it sent."""
    wire = request_to_wire(r)
    if override_id is not None:
        wire["id"] = override_id
    return _msg("response", request=wire)


def goodbye(reason: str = "") -> dict:
    return _msg("goodbye", reason=reason)


def goodbye_ack() -> dict:
    return _msg("goodbye_ack")


def iter_frames(data: bytes) -> Iterator[dict]:
    """Decode a fully-buffered byte string (tests / JSONL-style captures)."""
    dec = FrameDecoder()
    yield from dec.feed(data)
