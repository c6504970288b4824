"""Action latency profiles (§5.3 "action profiles").

Per (action type, model, batch size) the controller keeps the last K measured
durations and predicts with the window maximum — the paper's "rolling 99th
percentile" (K=10 makes max == p99+). Seed estimates come from offline
profiling (Table 1 / roofline-derived profiles).
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

Key = Tuple[str, str, int]          # (action_type, model_id, batch)


class ActionProfiler:
    def __init__(self, window: int = 10, safety: float = 1.0):
        self.window = window
        self.safety = safety
        self._hist: Dict[Key, collections.deque] = {}
        self._seed: Dict[Key, float] = {}

    def seed(self, action_type: str, model_id: str, batch: int,
             duration: float):
        self._seed[(action_type, model_id, batch)] = duration

    def observe(self, action_type: str, model_id: str, batch: int,
                duration: float):
        """Add one measured duration. Prediction errors (Fig 9) are read
        from the Recorder's ActionRecords (`prediction_error_report`)."""
        key = (action_type, model_id, batch)
        dq = self._hist.setdefault(key,
                                   collections.deque(maxlen=self.window))
        dq.append(duration)

    def estimate(self, action_type: str, model_id: str, batch: int):
        key = (action_type, model_id, batch)
        dq = self._hist.get(key)
        if dq:
            return max(dq) * self.safety
        s = self._seed.get(key)
        return None if s is None else s * self.safety

    def estimate_or(self, action_type: str, model_id: str, batch: int,
                    default: float) -> float:
        e = self.estimate(action_type, model_id, batch)
        return default if e is None else e

    def history(self) -> Dict[Key, list]:
        """Snapshot of the observation windows — the hook ProfileStore uses
        to fold a live run's measurements back into the persistent store."""
        return {k: list(dq) for k, dq in self._hist.items() if dq}

    def seeds(self) -> Dict[Key, float]:
        return dict(self._seed)

    def known_batches(self, action_type: str, model_id: str):
        out = set()
        for (a, m, b) in self._hist:
            if a == action_type and m == model_id:
                out.add(b)
        for (a, m, b) in self._seed:
            if a == action_type and m == model_id:
                out.add(b)
        return sorted(out)
