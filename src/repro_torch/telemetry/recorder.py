"""Low-overhead telemetry recorder (ring buffers + JSONL export).

The Recorder is the single sink for the controller's telemetry stream.
Hot-path cost is one dict lookup plus attribute writes per event; storage
is two bounded deques (ring buffers), so a sustained run can never grow
memory without bound — old records are dropped and counted instead.

Event flow (see DESIGN.md §3):

    on_request ──► span_open
    send_action ─► span_dispatch          (EXEC actions carrying requests)
    on_result ───► record_action          (every result => ActionRecord)
               ├─► span_exec              (successful EXEC)
               └─► span_load              (successful LOAD => cold-start
                                           attribution to waiting spans)
    complete/reject ─► span_close
    scheduler.tick ──► record_gauge       (per-tick control-plane latency)
"""
from __future__ import annotations

import collections
import json
import math
import os
from typing import Dict, Iterable, Optional

from repro_torch.telemetry.events import ActionRecord, GaugeSample, RequestSpan


class Recorder:
    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.actions: collections.deque = collections.deque(maxlen=capacity)
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.gauges: Dict[str, collections.deque] = {}
        self._open: Dict[int, RequestSpan] = {}
        # per-model view of _open so LOAD attribution touches only the
        # spans of the loaded model, not every open span in the system
        self._open_by_model: Dict[str, Dict[int, RequestSpan]] = {}
        self.dropped_actions = 0
        self.dropped_spans = 0
        self.dropped_gauges = 0
        # continuous JSONL streaming (stream_to): long-running daemons
        # write records as they close instead of one end-of-run export
        self._stream_f = None
        self._stream_path: Optional[str] = None
        self._stream_bytes = 0
        self._rotate_bytes: Optional[int] = None
        self._rotate_keep = 4
        self.stream_lines = 0
        self.stream_rotations = 0

    # ------------------------------------------------------------- spans
    def span_open(self, req, queued: float):
        """Open a span at controller admission. `req` is duck-typed
        (needs id/model_id/arrival/slo)."""
        s = RequestSpan(
            request_id=req.id, model_id=req.model_id, arrival=req.arrival,
            slo=req.slo, queued=queued)
        self._open[req.id] = s
        per_model = self._open_by_model.get(req.model_id)
        if per_model is None:
            per_model = self._open_by_model[req.model_id] = {}
        per_model[req.id] = s

    def span_dispatch(self, request_ids, when: float, worker_id: str,
                      gpu_id: int, batch_size: int):
        for rid in request_ids:
            s = self._open.get(rid)
            if s is None:
                continue
            s.dispatched = when
            s.worker_id = worker_id
            s.gpu_id = gpu_id
            s.batch_size = batch_size
            s.attempts += 1

    def span_exec(self, request_ids, t_start: float, t_end: float):
        for rid in request_ids:
            s = self._open.get(rid)
            if s is not None:
                s.exec_start = t_start
                s.exec_end = t_end

    def span_remote(self, request_id: int, arrival, completion):
        """Stamp the controller-side [admission, completion] interval onto
        an open *client-side* span (the RESPONSE echoes both stamps). Both
        stamps share the controller clock, so their difference — and thus
        the span's `net_overhead` — is immune to client/controller skew."""
        s = self._open.get(request_id)
        if s is None or arrival is None or completion is None:
            return
        s.remote_arrival = arrival
        s.remote_completion = completion

    def span_load(self, model_id: str, t_start: float, t_end: float):
        """Attribute a completed LOAD to the requests it unblocked: open
        spans of that model still waiting to be dispatched. Already-
        dispatched spans were served by an existing replica — a
        replication LOAD elsewhere is not their cold start."""
        for s in self._open_by_model.get(model_id, {}).values():
            if math.isnan(s.dispatched) and math.isnan(s.load_start):
                s.load_start = t_start
                s.load_end = t_end
                s.cold_start = True

    def span_close(self, req, when: float):
        s = self._open.pop(req.id, None)
        if s is None:
            return None
        per_model = self._open_by_model.get(s.model_id)
        if per_model is not None:
            per_model.pop(req.id, None)
            if not per_model:
                del self._open_by_model[s.model_id]
        s.response = when
        s.status = req.status
        if len(self.spans) == self.capacity:
            self.dropped_spans += 1
        self.spans.append(s)
        if self._stream_f is not None:
            self._stream_write("span", s.to_dict())
        return s

    # ----------------------------------------------------------- actions
    def record_action(self, result, predicted: Optional[float]):
        """Build an ActionRecord from a worker Result (duck-typed)."""
        if len(self.actions) == self.capacity:
            self.dropped_actions += 1
        rec = ActionRecord(
            action_id=result.action_id,
            action_type=getattr(result.action_type, "value",
                                str(result.action_type)),
            model_id=result.model_id, worker_id=result.worker_id,
            gpu_id=result.gpu_id, batch_size=result.batch_size,
            status=getattr(result.status, "value", str(result.status)),
            t_received=getattr(result, "t_received", 0.0),
            t_start=result.t_start, t_end=result.t_end,
            actual=result.duration, predicted=predicted,
            request_ids=tuple(result.request_ids))
        self.actions.append(rec)
        if self._stream_f is not None:
            self._stream_write("action", rec.to_dict())
        return rec

    # ------------------------------------------------------------ gauges
    def record_gauge(self, name: str, t: float, value: float) -> None:
        """Append one named control-plane sample (e.g. scheduler tick
        latency). One dict lookup + deque append on the hot path."""
        dq = self.gauges.get(name)
        if dq is None:
            dq = self.gauges[name] = collections.deque(maxlen=self.capacity)
        if len(dq) == self.capacity:
            self.dropped_gauges += 1
        g = GaugeSample(name=name, t=t, value=value)
        dq.append(g)
        if self._stream_f is not None:
            self._stream_write("gauge", g.to_dict())

    def iter_gauges(self, name: Optional[str] = None):
        if name is not None:
            return iter(self.gauges.get(name, ()))
        return (g for dq in self.gauges.values() for g in dq)

    # --------------------------------------------------------- streaming
    def stream_to(self, path: str, rotate_bytes: Optional[int] = None,
                  rotate_keep: int = 4) -> None:
        """Continuously append every closed span / action record / gauge
        sample to `path` as JSONL. When `rotate_bytes` is set and the live
        file exceeds it, the file rotates (`path` -> `path.1` -> ... ->
        `path.<rotate_keep>`, oldest dropped) — so a long-running daemon's
        telemetry never grows one file without bound."""
        self.close_stream()
        self._stream_path = path
        self._rotate_bytes = rotate_bytes
        self._rotate_keep = max(1, rotate_keep)
        # binary mode: the rotation bound counts encoded bytes, and tell()
        # on an append stream is the true file size
        self._stream_f = open(path, "ab")
        self._stream_bytes = self._stream_f.tell()

    def _stream_write(self, kind: str, d: dict) -> None:
        # allow_nan: best-effort spans carry slo=inf (Python JSON extension)
        data = (json.dumps({"kind": kind, **d}, separators=(",", ":"),
                           allow_nan=True) + "\n").encode("utf-8")
        self._stream_f.write(data)
        self._stream_bytes += len(data)
        self.stream_lines += 1
        if self._rotate_bytes is not None \
                and self._stream_bytes >= self._rotate_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._stream_f.close()
        path = self._stream_path
        oldest = f"{path}.{self._rotate_keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for k in range(self._rotate_keep - 1, 0, -1):
            src = f"{path}.{k}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{k + 1}")
        os.replace(path, f"{path}.1")
        self._stream_f = open(path, "wb")
        self._stream_bytes = 0
        self.stream_rotations += 1

    def close_stream(self) -> None:
        """Flush and stop streaming (daemon shutdown path)."""
        if self._stream_f is not None:
            self._stream_f.close()
            self._stream_f = None

    # ------------------------------------------------------------ export
    def iter_actions(self) -> Iterable[ActionRecord]:
        return iter(self.actions)

    def iter_spans(self) -> Iterable[RequestSpan]:
        return iter(self.spans)

    def export_jsonl(self, path: str) -> int:
        """Write closed spans + action records as JSONL; returns #lines."""
        n = 0
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps({"kind": "span", **s.to_dict()},
                                   allow_nan=False) + "\n")
                n += 1
            for a in self.actions:
                f.write(json.dumps({"kind": "action", **a.to_dict()},
                                   allow_nan=False) + "\n")
                n += 1
            for g in self.iter_gauges():
                f.write(json.dumps({"kind": "gauge", **g.to_dict()},
                                   allow_nan=False) + "\n")
                n += 1
        return n

    def clear(self):
        self.actions.clear()
        self.spans.clear()
        self.gauges.clear()
        self._open.clear()
        self._open_by_model.clear()
