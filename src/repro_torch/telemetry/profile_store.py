"""Persistent action-profile store (§5.2 offline profiling, Table 1).

Clockwork seeds its scheduler with latency profiles measured *offline*,
then refines them online. This module is the persistence layer: a
versioned JSON file mapping (action_type, model_id, batch) to a latency
profile (count/median/p99/max seconds). It is written by the offline
profiler CLI (`python -m repro.telemetry.profiler`) and by shutdown
updates from live telemetry, and read at startup to seed ActionProfiler —
so repeat runs skip warmup re-measurement entirely.

File format (STORE_VERSION = 1):

    {"version": 1,
     "entries": [{"action_type": "INFER", "model_id": "resnet_tiny",
                  "batch": 1, "count": 12, "median_s": 0.0021,
                  "p99_s": 0.0024, "max_s": 0.0025}, ...]}
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.telemetry.reports import quantile

STORE_VERSION = 1

Key = Tuple[str, str, int]          # (action_type, model_id, batch)


@dataclasses.dataclass
class LatencyProfile:
    count: int
    median_s: float
    p99_s: float
    max_s: float

    @classmethod
    def from_durations(cls, durs: Sequence[float]) -> "LatencyProfile":
        if not durs:
            raise ValueError("empty duration list")
        return cls(count=len(durs), median_s=quantile(durs, 0.5),
                   p99_s=quantile(durs, 0.99), max_s=max(durs))

    def merged(self, other: "LatencyProfile") -> "LatencyProfile":
        """Approximate merge: medians are count-weighted, tails take max."""
        n = self.count + other.count
        med = (self.median_s * self.count + other.median_s * other.count) / n
        return LatencyProfile(count=n, median_s=med,
                              p99_s=max(self.p99_s, other.p99_s),
                              max_s=max(self.max_s, other.max_s))

    @property
    def estimate(self) -> float:
        """Conservative seed estimate (matches the predictor's window-max)."""
        return self.max_s


class ProfileStore:
    def __init__(self):
        self.profiles: Dict[Key, LatencyProfile] = {}

    # -------------------------------------------------------------- CRUD
    def put(self, action_type: str, model_id: str, batch: int,
            profile: LatencyProfile):
        self.profiles[(action_type, model_id, batch)] = profile

    def get(self, action_type: str, model_id: str,
            batch: int) -> Optional[LatencyProfile]:
        return self.profiles.get((action_type, model_id, batch))

    def update(self, action_type: str, model_id: str, batch: int,
               durations: Sequence[float]):
        """Merge a batch of measured durations into the stored profile."""
        if not durations:
            return
        new = LatencyProfile.from_durations(durations)
        key = (action_type, model_id, batch)
        old = self.profiles.get(key)
        self.profiles[key] = new if old is None else old.merged(new)

    def __len__(self) -> int:
        return len(self.profiles)

    def items(self):
        return self.profiles.items()

    def model_ids(self):
        return sorted({mid for (_, mid, _) in self.profiles})

    # ----------------------------------------------------- telemetry I/O
    def update_from_recorder(self, recorder):
        """Fold successful ActionRecords from a live run into the store."""
        by_key: Dict[Key, list] = {}
        for a in recorder.iter_actions():
            if a.status == "SUCCESS" and a.actual > 0:
                by_key.setdefault(
                    (a.action_type, a.model_id, a.batch_size),
                    []).append(a.actual)
        for (t, mid, b), durs in by_key.items():
            self.update(t, mid, b, durs)

    def update_from_profiler(self, profiler):
        """Fold an ActionProfiler's observation windows into the store."""
        for (t, mid, b), durs in profiler.history().items():
            self.update(t, mid, b, durs)

    def seed_profiler(self, profiler):
        """Seed an ActionProfiler with the conservative stored estimates."""
        for (t, mid, b), p in self.profiles.items():
            profiler.seed(t, mid, b, p.estimate)

    def seed_dict(self) -> Dict[Key, float]:
        """(action_type, model_id, batch) -> seconds, the format
        `Controller.add_worker(profiles=...)` accepts."""
        return {k: p.estimate for k, p in self.profiles.items()}

    # ------------------------------------------------------- persistence
    def save(self, path: str) -> str:
        entries = [{"action_type": t, "model_id": mid, "batch": b,
                    **dataclasses.asdict(p)}
                   for (t, mid, b), p in sorted(self.profiles.items())]
        payload = {"version": STORE_VERSION, "entries": entries}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # atomic write: a crashed profiler never leaves a torn store
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    @classmethod
    def load(cls, path: str) -> "ProfileStore":
        with open(path) as f:
            payload = json.load(f)
        version = payload.get("version")
        if version != STORE_VERSION:
            raise ValueError(
                f"profile store {path}: version {version!r}, "
                f"expected {STORE_VERSION}")
        store = cls()
        for e in payload["entries"]:
            store.put(e["action_type"], e["model_id"], int(e["batch"]),
                      LatencyProfile(count=int(e["count"]),
                                     median_s=float(e["median_s"]),
                                     p99_s=float(e["p99_s"]),
                                     max_s=float(e["max_s"])))
        return store

    @classmethod
    def load_if_exists(cls, path: str) -> Optional["ProfileStore"]:
        return cls.load(path) if os.path.exists(path) else None
