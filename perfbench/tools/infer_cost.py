"""What the engine's own INFER timing costs on the card: this checkout's
``TorchModel._forward`` against another checkout's (``--parent``), on one
model of one deployment, in one process, in alternating blocks.

    python3 perfbench/tools/infer_cost.py --parent <checkout> \
        --workload resnet50.poisson --seed 7 --n 400

Builds the cell's deployment from this checkout, loads the other
checkout's ``serving/engine.py`` beside it (its ``_forward`` runs on the
same ``TorchModel``: same weights, inputs and card), warms up bucket 1, and
times ``--n`` passes of each ``_forward`` in blocks of ``--block``, in the
order new, old, old, new, ...: the seconds each returns (what the
controller sees) and the host seconds each call takes (input included).
Then the same again inside one ``torch.profiler`` session with CPU and
CUDA activities, as a traced run has, where this checkout's ``_forward``
also opens its ``record_function`` ranges. A model's host time swings by
more than the timing costs, so both are also measured on an empty model
(a ``TorchModel`` whose input and forward do nothing on the card): there
the difference between the two sides is the cost alone, without and with
a profiler session. Prints one JSON line: medians and means of both sides,
the card's name and power limit, and the medians of this checkout's
phases. Not run by the benchmark.
"""
import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
EMPTY_N = (20000, 2000)     # empty-model passes a side: untraced, profiled


def _alternate(tm, forwards, n, block):
    """``n`` passes of each of ``forwards`` (name -> unbound _forward) in
    blocks, the order reversed every block; per side the returned and the
    call seconds, and this checkout's phases."""
    b = tm.bucket(1)
    names = list(forwards)
    got = {k: {"returned": [], "call": []} for k in names}
    phases = []
    for i in range(0, n, block):
        for k in (names if (i // block) % 2 == 0 else names[::-1]):
            for _ in range(min(block, n - i)):
                t0 = time.perf_counter()
                _, d = forwards[k](tm, b)
                got[k]["call"].append(time.perf_counter() - t0)
                got[k]["returned"].append(d)
                if k == "new":
                    phases.append(tm.last_phases)
    out = {}
    for k, v in got.items():
        out[k] = {f"{m}_ms_{s}": 1e3 * f(v[m]) for m in ("returned", "call")
                  for s, f in (("p50", statistics.median),
                               ("mean", statistics.fmean))}
    for f in ("input_s", "launch_s", "wait_s", "device_s"):
        vals = [getattr(p, f) for p in phases]
        if None not in vals:            # device_s is None off the card
            out["new"][f"{f[:-2]}_ms_p50"] = 1e3 * statistics.median(vals)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the checkout whose engine is compared")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--block", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness import manifest
    from repro_torch.serving.engine import TorchModel
    path = (Path(args.parent).resolve()
            / "src/repro_torch/serving/engine.py")
    spec = importlib.util.spec_from_file_location("parent_engine", path)
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    forwards = {"new": TorchModel._forward,
                "old": parent.TorchModel._forward}

    c = manifest.load(ROOT, args.workload)
    dev = torch.device("cuda")
    deploy = c.adapter().build(c.sizes, c.cell, args.seed, dev, None, None)
    tm = next(iter(deploy.engines.values()))
    for _ in range(args.warmup):
        tm.run(1)
    row = {"parent": str(path), "workload": args.workload,
           "seed": args.seed, "n": args.n, "block": args.block,
           "device": torch.cuda.get_device_name(dev),
           "power_limit": subprocess.run(
               ["nvidia-smi", "--query-gpu=power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "untraced": _alternate(tm, forwards, args.n, args.block)}
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        row["profiled"] = _alternate(tm, forwards, args.n, args.block)
    empty = TorchModel("empty", lambda p, x: x, {}, lambda b: None, 0,
                       batches=(1,), device=dev)
    empty.device_params = {}
    row["empty"] = _alternate(empty, forwards, EMPTY_N[0], 100)
    with profile(activities=activities):
        row["empty_profiled"] = _alternate(empty, forwards, EMPTY_N[1], 100)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
