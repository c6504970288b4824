"""Deterministic synthetic LM data pipeline.

Produces next-token-prediction batches from a seeded Markov token stream —
deterministic given (seed, step), so the pipeline is *stateless-resumable*:
restoring a checkpoint at step N reproduces exactly the batches the crashed
run would have seen (the fault-tolerance contract training relies on).

A background prefetch thread overlaps host batch synthesis with device
compute (double-buffering), mirroring a production input pipeline.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec


class SyntheticLM:
    """Markov-chain token stream with a learnable structure (so training
    loss visibly decreases): P(next | cur) concentrated on a few successors.
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                 branching: int = 4):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.vocab = cfg.vocab_size
        rng = np.random.default_rng(seed)
        self.succ = rng.integers(0, self.vocab,
                                 size=(min(self.vocab, 4096), branching),
                                 dtype=np.int32)

    def _tokens(self, step: int, batch: int, length: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        out = np.empty((batch, length + 1), np.int32)
        cur = rng.integers(0, self.vocab, size=batch, dtype=np.int32)
        out[:, 0] = cur
        choices = rng.integers(0, self.succ.shape[1],
                               size=(batch, length), dtype=np.int32)
        for t in range(length):
            cur = self.succ[cur % self.succ.shape[0], choices[:, t]]
            out[:, t + 1] = cur
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        B, S = shape.global_batch, shape.seq_len
        if cfg.is_encdec:
            rng = np.random.default_rng((self.seed, step, 7))
            toks = self._tokens(step, B, S)
            return {
                "frames": rng.standard_normal((B, S, cfg.d_model)
                                              ).astype(np.float32) * 0.02,
                "tokens": toks[:, :-1],
                "targets": toks[:, 1:],
            }
        if cfg.modality == "image_patches":
            st = S - cfg.img_tokens
            rng = np.random.default_rng((self.seed, step, 7))
            toks = self._tokens(step, B, st)
            return {
                "tokens": toks[:, :-1],
                "image_embeds": rng.standard_normal(
                    (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)
                * 0.02,
                "targets": toks[:, 1:],
            }
        toks = self._tokens(step, B, S)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class Prefetcher:
    """Double-buffered background prefetch; resumable via start_step."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            b = self.source.batch(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
