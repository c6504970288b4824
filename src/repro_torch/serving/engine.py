"""Real PyTorch execution backend for the Clockwork worker (port of
``repro.serving.engine``).

Mirrors the paper's model runtime (§5.1): weights live in (pinned) host
memory and LOAD copies them to the card; EXEC runs one forward at a time and
is timed on the host clock around work that ends in
``torch.cuda.synchronize``; the measured times feed the controller's
profiler and a ``ProfileStore`` in the reference's format.

``compile()`` runs one untimed pass per batch bucket, which builds the CUDA
kernels; CUDA-graph capture of the buckets is a later step.

Each INFER is timed in phases (``Phases``): the input (``make_input`` and
the synchronise that waits for its copy, outside the returned duration),
the launch (the forward's call, which enqueues its kernels), the wait (the
synchronise after it) and, on a card, the device time between two CUDA
events recorded around the launch. The returned duration is launch + wait.
While a ``torch.profiler`` session records, and only then, the INFER and
its phases are also ``record_function`` ranges on the profiler's clock:
``clockwork.infer action=<id> model=<id> batch=<n> bucket=<n>`` (the name
carries the arguments: the profiler keeps no ``record_function`` args) with
``clockwork.infer.input``, ``.launch`` and ``.wait`` inside it, and, in an
LM's forward, ``clockwork.decode.cache`` and ``clockwork.decode.step``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.actions import Phases
from repro_torch.core.worker import ModelDef
from repro_torch.models import params as pspec
from repro_torch.models.resnet import (port_layout, resnet50_forward,
                                       resnet50_spec)
from repro_torch.telemetry.profile_store import ProfileStore
from repro_torch.utils import resolve_device, tree_map


INFER_RANGE = "clockwork.infer"
INPUT_RANGE, LAUNCH_RANGE, WAIT_RANGE = (
    f"{INFER_RANGE}.{p}" for p in ("input", "launch", "wait"))
_NO_RANGE = contextlib.nullcontext()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _range(on: bool, name: str):
    """A ``record_function`` range named ``name`` when ``on`` (a profiler
    session records), else a shared no-op: nothing is built."""
    return record_function(name) if on else _NO_RANGE


class TorchModel:
    """One served model: host weights + a forward run per batch bucket."""

    def __init__(self, model_id: str, forward: Callable, params,
                 make_input: Callable[[int], tuple], weights_bytes: int,
                 batches: Tuple[int, ...] = (1, 2, 4, 8, 16),
                 device="cuda"):
        self.model_id = model_id
        self.forward = forward
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"
        self.host_params = tree_map(
            lambda t: t.to("cpu").pin_memory() if pin else t.to("cpu"), params)
        self.device_params = None
        self.make_input = make_input
        self.weights_bytes = weights_bytes
        self.batches = tuple(sorted(batches))
        self._measured: Dict[Tuple[str, int], float] = {}
        self._load_s: Optional[float] = None
        self._fresh: set = set()     # keys measured in-process (not echoes)
        self.warmup_count = 0        # timed profiling measurements performed
        self.last_phases: Optional[Phases] = None   # of the last forward
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if self.device.type == "cuda" else None)

    def load(self) -> float:
        """Copy the host weights to the device; returns the seconds taken."""
        t0 = time.perf_counter()
        self.device_params = tree_map(
            lambda t: t.to(self.device, non_blocking=True), self.host_params)
        _sync(self.device)
        return time.perf_counter() - t0

    def unload(self):
        self.device_params = None

    def bucket(self, batch: int) -> int:
        for b in self.batches:
            if b >= batch:
                return b
        return self.batches[-1]

    def _forward(self, b: int, batch: Optional[int] = None,
                 action_id: Optional[int] = None):
        """One pass at bucket ``b`` carrying ``batch`` requests (default
        ``b``) for action ``action_id``: returns (output, launch + wait
        seconds) and leaves the phases in ``last_phases``."""
        on = torch.autograd._profiler_enabled()
        infer = (record_function(
            f"{INFER_RANGE} action={action_id} model={self.model_id} "
            f"batch={b if batch is None else batch} bucket={b}")
            if on else _NO_RANGE)
        ev = self._events
        with infer:
            t0 = time.perf_counter()
            with _range(on, INPUT_RANGE):
                x = self.make_input(b)
                _sync(self.device)
            t1 = time.perf_counter()
            with _range(on, LAUNCH_RANGE):
                if ev is not None:
                    stream = torch.cuda.current_stream(self.device)
                    ev[0].record(stream)
                with torch.inference_mode():
                    out = self.forward(self.device_params, x)
                if ev is not None:
                    ev[1].record(stream)
            t2 = time.perf_counter()
            with _range(on, WAIT_RANGE):
                _sync(self.device)
            t3 = time.perf_counter()
        launch_s, wait_s = t2 - t1, t3 - t2
        self.last_phases = Phases(
            input_s=t1 - t0, launch_s=launch_s, wait_s=wait_s,
            device_s=None if ev is None else ev[0].elapsed_time(ev[1]) / 1e3)
        return out, launch_s + wait_s

    def run(self, batch: int, action_id: Optional[int] = None) -> float:
        if self.device_params is None:
            self.load()
        return self._forward(self.bucket(batch), batch, action_id)[1]

    def compile(self):
        """One untimed pass per batch bucket (builds the kernels) — not a
        warmup re-measurement (paper §5.1: profiles come from the
        ProfileStore)."""
        if self.device_params is None:
            self.load()
        for b in self.batches:
            self._forward(b)

    # ------------------------------------------------------ profiling
    def measure(self, reps: int = 3) -> Dict[Tuple[str, int], list]:
        """Timed sweep over batch buckets; returns raw durations per
        ("INFER", batch). The first rep per bucket (warm-up) is dropped."""
        if self.device_params is None:
            self.load()
        out = {}
        for b in self.batches:
            durs = [self.run(b) for _ in range(reps + 1)][1:]
            self.warmup_count += reps + 1
            out[("INFER", b)] = durs
        return out

    def measure_load(self, reps: int = 2) -> List[float]:
        """Timed host->device weight transfers (the LOAD profile)."""
        durs = []
        for _ in range(max(1, reps)):
            self.unload()
            durs.append(max(self.load(), 1e-5))
            self.warmup_count += 1
        self._load_s = float(np.median(durs))
        self._fresh.add(("LOAD", 1))
        return durs

    def warmup(self, reps: int = 3):
        for (t, b), durs in self.measure(reps=reps).items():
            self._measured[(t, b)] = float(np.median(durs))
            self._fresh.add((t, b))

    def apply_profile(self, entries: Dict[Tuple[str, int], float]):
        """Seed measurements from persisted profiles — {("INFER", batch)
        or ("LOAD", 1): seconds} — so no warmup re-measurement happens."""
        for (t, b), d in entries.items():
            if t == "LOAD":
                self._load_s = float(d)
            else:
                self._measured[(t, b)] = float(d)
            self._fresh.discard((t, b))

    def seed_from_store(self, store: ProfileStore) -> bool:
        """Seed from a ProfileStore; returns False (and seeds nothing) if
        any of this model's batch buckets is missing from the store."""
        entries = {}
        for b in self.batches:
            p = store.get("INFER", self.model_id, b)
            if p is None:
                return False
            entries[("INFER", b)] = p.estimate
        lp = store.get("LOAD", self.model_id, 1)
        if lp is not None:
            entries[("LOAD", 1)] = lp.estimate
        self.apply_profile(entries)
        return True

    def seed_profiles(self) -> dict:
        if not self._measured:
            self.warmup()
        out = {("INFER", self.model_id, b): d
               for (_, b), d in self._measured.items()}
        if self._load_s is None:
            self.measure_load(reps=1)
        out[("LOAD", self.model_id, 1)] = self._load_s
        return out

    def fresh_profiles(self) -> dict:
        """Like seed_profiles(), restricted to values measured in this
        process — store-seeded echoes are excluded, so folding these back
        into a ProfileStore can never recycle its own estimates."""
        return {(t, mid, b): d
                for (t, mid, b), d in self.seed_profiles().items()
                if (t, b) in self._fresh}

    def modeldef(self) -> ModelDef:
        if not self._measured:
            self.warmup()
        return ModelDef(model_id=self.model_id,
                        weights_bytes=self.weights_bytes,
                        exec_latency={("INFER", b): d for (_, b), d
                                      in self._measured.items()},
                        runner=self.run)


class TorchBackend:
    """Worker backend that actually executes (RealClock mode)."""

    realtime = True
    load_fixed = 1e-4

    def __init__(self, models: Dict[str, TorchModel]):
        self.models = models
        # (action id, Phases) of the INFER run last, until taken
        self._phases: Tuple[Optional[int], Optional[Phases]] = (None, None)

    def load_duration(self, model: ModelDef) -> float:
        return max(self.models[model.model_id].load(), 1e-6)

    def exec_duration(self, model: ModelDef, action) -> float:
        tm = self.models[model.model_id]
        d = tm.run(action.batch_size, action.id)
        self._phases = (action.id, tm.last_phases)
        return max(d, 1e-6)

    def take_phases(self, action_id: int) -> Optional[Phases]:
        """The phases of ``action_id`` if it is the INFER run last, once;
        else None (a LOAD, or already taken)."""
        aid, phases = self._phases
        if aid != action_id:
            return None
        self._phases = (None, None)
        return phases


def seed_engines(engines: Dict[str, TorchModel],
                 store: Optional[ProfileStore] = None) -> dict:
    """Seed every engine's profiles — from `store` when it covers the
    engine's buckets (zero warmup re-measurement), measuring otherwise —
    and return the combined (type, model, batch) -> secs dict that
    `Controller.add_worker(profiles=...)` takes."""
    profiles = {}
    for e in engines.values():
        if store is not None:
            e.seed_from_store(store)
        profiles.update(e.seed_profiles())
    return profiles


def update_store(engines: Dict[str, TorchModel], store: ProfileStore,
                 controller=None) -> ProfileStore:
    """Shutdown path: fold measured engine profiles and (optionally) the
    controller's live telemetry back into the persistent store. Only values
    measured this run (fresh_profiles) are folded, and live telemetry only
    from the Recorder (the ActionProfiler holds the same durations)."""
    for e in engines.values():
        for (t, mid, b), d in e.fresh_profiles().items():
            store.update(t, mid, b, [d])
    if controller is not None:
        store.update_from_recorder(controller.recorder)
    return store


def make_resnet_model(model_id: str, scale: int = 16, img: int = 64,
                      batches=(1, 2, 4, 8, 16), seed: int = 0,
                      device="cuda") -> TorchModel:
    """ResNet-50 (the paper's evaluation model), 256 classes; ``scale=1,
    img=224`` is full width. Weights are random, drawn on the CPU from
    ``seed``; the inputs are the reference's draws, in order, from a numpy
    generator seeded with ``seed``, as NCHW ``channels_last`` tensors on the
    device. Raises when ``device`` is CUDA and no card is present."""
    dev = resolve_device(device)
    spec = resnet50_spec(num_classes=256, scale=scale)
    params = port_layout(pspec.materialize(
        spec, torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)

    def make_input(b):
        x = rng.standard_normal((b, img, img, 3)).astype(np.float32)
        return torch.from_numpy(x).to(dev).permute(0, 3, 1, 2)

    return TorchModel(model_id, resnet50_forward, params, make_input,
                      weights_bytes=pspec.param_bytes(spec), batches=batches,
                      device=dev)


def make_lm_decode_model(model_id: str, arch: str = "qwen2-0.5b",
                         batches=(1, 2, 4, 8), ctx: int = 128, seed: int = 0,
                         full: bool = False, device="cuda") -> TorchModel:
    """LM whose INFER action is one DECODE step (the Clockwork-for-LLMs
    adaptation, DESIGN.md §2), for any decoder-only ``arch`` (an
    encoder-decoder model would need a cross cache, which the reference's
    factory does not build either). ``full=True`` takes the published
    widths (``get_config``); the default is the reference's smoke config.
    Weights are random, drawn on the CPU from ``seed``. Raises when
    ``device`` is CUDA and no card is present."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.registry import get_bundle
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_smoke_config(arch)
    bundle = get_bundle(cfg)
    params = bundle.init(torch.Generator().manual_seed(seed))

    def forward(p, x):
        # one decode step against a zeroed ctx-sized cache, made inside the
        # timed call as in the reference (the contents don't affect the cost)
        tokens, cur = x
        on = torch.autograd._profiler_enabled()
        with _range(on, "clockwork.decode.cache"):
            cache = bundle.init_cache(tokens.shape[0], ctx, device=dev)
        with _range(on, "clockwork.decode.step"):
            logits, _ = bundle.decode(p, cache, tokens, cur)
        return logits

    def make_input(b):
        return torch.zeros((b, 1), dtype=torch.int64, device=dev), ctx // 2

    return TorchModel(model_id, forward, params, make_input,
                      weights_bytes=pspec.param_bytes(bundle.spec()),
                      batches=batches, device=dev)
