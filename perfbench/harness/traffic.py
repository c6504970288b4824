"""The open-loop generator: one schedule of (due time, model) pairs per run,
read from a cell's traffic parameters and drawn from ``--seed``.

Frozen copy of ``repro_torch.serving.workload``'s ``OpenLoopClient``
Poisson arrivals, changed in two ways:

* every request carries the time it was **due**, so a stall of the event
  loop shows as lateness and is not re-stamped away;
* each stream's count in each phase (warm-up, window) is fixed: the
  expected count, rounded. ``--seed`` draws the times (a Poisson process
  conditioned on its count), so every seed offers the same work in another
  order.

Traffic parameters (a cell file's ``"traffic"`` object):

``shape``       ``"poisson"`` (equal shares; the only shape so far)
``rate``        total mean requests per second over the window
``slo_ms``      each request's latency limit
``warmup_s``    seconds of the same traffic before the window
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

GRID_S = 1e-3        # the rate functions are integrated on this grid


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *stream])


def rate_grid(traffic: dict, n_models: int, span_s: float,
              window: Tuple[float, float]) -> np.ndarray:
    """(n_models, steps) requests per second on the ``GRID_S`` grid over
    [0, span_s), scaled so that the window's mean total rate is
    ``traffic["rate"]``."""
    steps = int(round(span_s / GRID_S))
    if traffic["shape"] != "poisson":
        raise ValueError(f"unknown traffic shape {traffic['shape']!r}")
    grid = np.ones((n_models, steps))
    a, b = (int(round(w / GRID_S)) for w in window)
    window_mean = grid[:, a:b].sum() / (b - a)
    return grid * (traffic["rate"] / window_mean)


def _draw(rates: np.ndarray, t0: float, count: int,
          rng: np.random.Generator) -> np.ndarray:
    """``count`` times in [t0, t0 + len(rates) * GRID_S) with density
    proportional to ``rates``: a Poisson process conditioned on its count."""
    if count == 0:
        return np.zeros(0)
    cdf = np.cumsum(rates)
    cell = np.searchsorted(cdf, rng.random(count) * cdf[-1], side="right")
    cell = np.minimum(cell, len(rates) - 1)
    return t0 + (cell + rng.random(count)) * GRID_S


def schedule(traffic: dict, n_models: int, seed: int,
             seconds: float) -> Tuple[np.ndarray, np.ndarray]:
    """The run's arrivals, sorted: (due times in seconds from the start of
    the warm-up, model indices). The window is [warmup_s, warmup_s +
    seconds); each stream's count in the warm-up and in the window is its
    expected count, rounded."""
    warm = float(traffic["warmup_s"])
    span = warm + seconds
    grid = rate_grid(traffic, n_models, span, (warm, span))
    edges = (0, int(round(warm / GRID_S)), grid.shape[1])
    due, model = [], []
    for i in range(n_models):
        for phase in range(2):
            lo, hi = edges[phase], edges[phase + 1]
            rates = grid[i, lo:hi]
            count = int(round(rates.sum() * GRID_S))
            times = _draw(rates, lo * GRID_S, count, _rng(seed, i, phase))
            due.append(times)
            model.append(np.full(len(times), i, dtype=np.int64))
    due = np.concatenate(due)
    model = np.concatenate(model)
    order = np.argsort(due, kind="stable")
    return due[order], model[order]


def expected_counts(traffic: dict, n_models: int,
                    seconds: float) -> Dict[str, List[int]]:
    """Each stream's fixed count in the warm-up and the window (the same
    for every seed)."""
    warm = float(traffic["warmup_s"])
    span = warm + seconds
    grid = rate_grid(traffic, n_models, span, (warm, span))
    a = int(round(warm / GRID_S))
    return {"warmup": [int(round(r.sum() * GRID_S)) for r in grid[:, :a]],
            "window": [int(round(r.sum() * GRID_S)) for r in grid[:, a:]]}
