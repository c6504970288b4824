"""Readings that the limits of the output comparison are set from: for
each seed, one run of the cell at its own load with a short window, its
program's numbers (the lower reading: float32 reference against the
served bfloat16 outputs), and the control's on the same samples (the
reference in float8 e4m3 put in the program's place against the float32
reference), each judged by the configuration's limits (``correct``,
``control_correct``). One process for all seeds.

    python3 perfbench/tools/control.py --workload qwen2-0.5b.decode \
        --seconds 6 --seeds 1 2 3 [--fault every_slot]

With ``--fault`` the run's timed path is broken as the fault tests break
it, at the cell's own size: its ``correct`` should read false.

Not run by the benchmark's own runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of perfbench/tests/faults.py")
    args = ap.parse_args()
    from perfbench.harness.cell import run_cell
    from perfbench.tests.faults import FAULTS
    fault = FAULTS[args.fault] if args.fault else None
    reuse = {}
    for seed in args.seeds:
        t0 = time.monotonic()
        out = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       device="cuda", control=True, reuse=reuse,
                       fault=fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault,
                          "program": out.program, "control": out.control,
                          "correct": out.result["correct"],
                          "control_correct": out.control_correct,
                          "summary": out.summary,
                          "seconds": time.monotonic() - t0}), flush=True)


if __name__ == "__main__":
    main()
