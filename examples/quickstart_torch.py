"""Quickstart for the PyTorch/CUDA port: serve real models through the
Clockwork controller on one card (the counterpart of examples/quickstart.py).

Starts an in-process cluster (controller + one worker with a TorchBackend),
registers two models (a reduced ResNet-50, the paper's evaluation model,
and a qwen2-0.5b decode engine), submits batched requests, and prints
latency and goodput beside the card's name and power limit.

Profiles persist across runs: the first run measures (or pre-measure with
``python -m repro_torch.telemetry.profiler``) and writes
experiments/profiles_torch.json; repeat runs seed from it and skip warmup.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--full] [--store PATH]

``--device`` is ``cuda`` unless the CPU is asked for; ``--full`` serves
full-width ResNet-50 (224x224) and qwen2-0.5b instead of the reduced ones.
"""
import argparse
import subprocess
import sys

sys.path.insert(0, "src")

from repro_torch.core.actions import Request
from repro_torch.core.clock import EventLoop, RealClock
from repro_torch.core.controller import Controller
from repro_torch.core.scheduler import ClockworkScheduler
from repro_torch.core.worker import Worker
from repro_torch.serving.engine import (TorchBackend, make_lm_decode_model,
                                        make_resnet_model, seed_engines,
                                        update_store)
from repro_torch.telemetry import ProfileStore
from repro_torch.utils import welford_summary

STORE_PATH = "experiments/profiles_torch.json"


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or what
    ran instead."""
    if device == "cpu":
        return "cpu (no card: every time below is a CPU time)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--store", default=STORE_PATH)
    args = ap.parse_args(argv)
    on = card(args.device)
    loop = EventLoop(RealClock())
    print(f"[quickstart] on {on}: running each model batch bucket once "
          "(builds the kernels, like the paper's per-batch-size kernels)...")
    resnet = dict(scale=1, img=224) if args.full else dict(scale=16, img=64)
    engines = {
        "resnet50_mini": make_resnet_model("resnet50_mini", batches=(1, 2, 4),
                                           device=args.device, **resnet),
        "qwen2_decode": make_lm_decode_model("qwen2_decode", "qwen2-0.5b",
                                             batches=(1, 2, 4), ctx=128,
                                             full=args.full,
                                             device=args.device),
    }
    store = ProfileStore.load_if_exists(args.store)
    if store is not None:
        print(f"[quickstart] seeding profiles from {args.store} "
              "(skipping warmup re-measurement)")
    profiles = seed_engines(engines, store)
    for e in engines.values():
        if e.warmup_count == 0:   # store-seeded: warmup did not run it
            e.compile()           # untimed: keeps kernel builds off the hot path
    models = {k: v.modeldef() for k, v in engines.items()}
    backend = TorchBackend(engines)
    worker = Worker("w0", loop, backend, models, n_gpus=1)
    controller = Controller(loop, models, ClockworkScheduler(),
                            action_delay=1e-4)
    controller.add_worker(worker, profiles)

    done = []
    controller.on_response = done.append

    slo = 2.0  # generous; the controller still schedules against it
    print("[quickstart] submitting 30 requests across 2 models...")
    for i in range(30):
        controller.on_request(Request(model_id=list(models)[i % 2],
                                      arrival=loop.now(), slo=slo))
        loop.run_until(loop.now() + 0.01)
    loop.run_until(loop.now() + 5.0)

    ok = [r for r in done if r.status == "ok"]
    lat = [r.completion - r.arrival for r in ok]
    print(f"[quickstart] {len(ok)}/{len(done)} within SLO on {on}; latency "
          f"stats (s): {welford_summary(lat)}")
    for mid in models:
        est = controller.profiler.estimate("INFER", mid, 1)
        print(f"[quickstart] learned INFER profile {mid} b1: "
              f"{est * 1e3:.2f} ms on {on}")

    rep = controller.telemetry_report()
    bd = rep["breakdown"]
    print(f"[quickstart] latency breakdown (median s): "
          f"queue={bd['queue']['median']:.4f} "
          f"exec={bd['exec']['median']:.4f} "
          f"total={bd['total']['median']:.4f}; "
          f"cold_starts={bd['cold_starts']}")
    update_store(engines, store or ProfileStore(), controller) \
        .save(args.store)
    print(f"[quickstart] profiles persisted -> {args.store}")
    return len(ok), len(done)


if __name__ == "__main__":
    main()
