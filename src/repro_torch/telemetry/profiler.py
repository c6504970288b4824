"""Offline profiler CLI (§5.2 / Table 1), port of
``repro.telemetry.profiler``.

Sweeps the registered serving models (reduced ResNet + LM decode engines
from `repro_torch.serving.engine`) across their batch buckets, measures
LOAD/INFER durations, writes a versioned ProfileStore, and prints a
Table-1-style report. A serving run started from the written store skips
warmup re-measurement entirely. The models run on the card unless
``--device cpu`` is given.

Usage:
    PYTHONPATH=src python -m repro_torch.telemetry.profiler \\
        --out experiments/profiles.json [--quick] [--reps 3] \\
        [--models resnet_tiny,qwen2_decode] [--batches 1,2,4] [--merge] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.telemetry.profile_store import ProfileStore
from repro_torch.telemetry.reports import profile_table

Spec = Tuple[str, Callable[[], "object"]]   # (model_id, TorchModel factory)


def default_specs(quick: bool = False,
                  batches: Optional[Tuple[int, ...]] = None,
                  device="cuda") -> List[Spec]:
    """The registered serving models (mirrors benchmarks/table1), on
    ``device``."""
    from repro_torch.serving.engine import make_lm_decode_model, make_resnet_model
    rb = batches or (1, 2, 4)
    specs: List[Spec] = [
        ("resnet_tiny", lambda: make_resnet_model(
            "resnet_tiny", scale=16, img=64, batches=rb, device=device)),
    ]
    if not quick:
        specs += [
            ("resnet_small", lambda: make_resnet_model(
                "resnet_small", scale=8, img=64, batches=rb, device=device)),
            ("qwen2_decode", lambda: make_lm_decode_model(
                "qwen2_decode", "qwen2-0.5b", batches=rb, ctx=128,
                device=device)),
            ("mamba2_decode", lambda: make_lm_decode_model(
                "mamba2_decode", "mamba2-130m", batches=rb, ctx=128,
                device=device)),
        ]
    return specs


def profile_engine(jm, reps: int = 3) -> Dict[Tuple[str, str, int], list]:
    """Measure one TorchModel; returns (action_type, model_id, batch) -> durs."""
    out = {}
    for (t, b), durs in jm.measure(reps=reps).items():
        out[(t, jm.model_id, b)] = durs
    out[("LOAD", jm.model_id, 1)] = jm.measure_load(reps=max(1, reps - 1))
    return out


def build_store(specs: List[Spec], reps: int = 3,
                store: Optional[ProfileStore] = None,
                verbose: bool = False) -> ProfileStore:
    store = store if store is not None else ProfileStore()
    for name, mk in specs:
        if verbose:
            print(f"[profiler] compiling + measuring {name} ...",
                  file=sys.stderr)
        jm = mk()
        for (t, mid, b), durs in profile_engine(jm, reps=reps).items():
            store.update(t, mid, b, durs)
        jm.unload()
    return store


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.profiler", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="experiments/profiles.json",
                    help="ProfileStore JSON path (default %(default)s)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions per batch bucket")
    ap.add_argument("--quick", action="store_true",
                    help="profile only the smallest ResNet")
    ap.add_argument("--models", default=None,
                    help="comma-separated subset of registered model ids")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch buckets (default 1,2,4)")
    ap.add_argument("--merge", action="store_true",
                    help="merge into an existing store instead of rewriting")
    ap.add_argument("--device", default="cuda",
                    help="device the models run on (default %(default)s)")
    args = ap.parse_args(argv)

    batches = None
    if args.batches:
        try:
            batches = tuple(int(b) for b in args.batches.split(","))
        except ValueError:
            ap.error(f"--batches must be comma-separated ints, "
                     f"got {args.batches!r}")
        if any(b < 1 for b in batches):
            ap.error("--batches entries must be >= 1")
    specs = default_specs(quick=args.quick, batches=batches,
                          device=args.device)
    if args.models:
        want = set(args.models.split(","))
        unknown = want - {n for n, _ in specs}
        if unknown:
            ap.error(f"unknown models {sorted(unknown)}; "
                     f"registered: {[n for n, _ in specs]}")
        specs = [(n, mk) for n, mk in specs if n in want]

    store = (ProfileStore.load_if_exists(args.out) or ProfileStore()) \
        if args.merge else ProfileStore()
    build_store(specs, reps=args.reps, store=store, verbose=True)
    path = store.save(args.out)
    print(f"[profiler] wrote {len(store)} profiles -> {path}")
    bs = batches or (1, 2, 4)
    for line in profile_table(store, batches=bs):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
