"""Run one cell of the port's benchmark on CUDA cards and print its line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the port (``src/repro_torch``). Standard output's last line is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last); standard error's
last lines are each compared number beside its limit. Without the cards
the cell asks for, or without the port, it exits with a code other than 0
and prints no result.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build caches at fixed paths inside the checkout: only a checkout's first
# run builds the kernels (the port's nvcc builds go to build/ by itself)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def fail(msg: str, code: int) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no port at {ROOT / 'src' / 'repro_torch'}", 2)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is false", 3)
    if torch.cuda.device_count() < chips[args.workload]:
        fail(f"{args.workload} needs {chips[args.workload]} cards, "
             f"{torch.cuda.device_count()} present", 3)

    from perfbench.harness.cell import run_cell
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=T_START,
                   echo=sys.stderr)
    for name, c in out.result["checks"].items():    # the last lines
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result, allow_nan=False))


if __name__ == "__main__":
    main()
