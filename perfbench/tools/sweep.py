"""Find a traffic shape's knee on the card: one deployment of a cell,
served at each of several total rates in turn (a fresh controller, worker
and scheduler each time), printing one JSON line per rate.

    python3 perfbench/tools/sweep.py --workload resnet50.poisson \
        --rates 1000 2000 4000 --seconds 10 --seeds 1 2

A rate is sustained when at least 99% of the window's requests end ``ok``
and the requests outstanding at the window's end exceed those at its
first third by less than one SLO's worth of arrivals (the ones still in
flight), on every seed. The knee is the highest rate sustained. The in-process
stack's goodput is not monotonic in the rate (PERF.md): read the whole
table, not only the knee. Not run by the benchmark; the rate it finds is
written into the cell's file by hand.
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
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from perfbench.harness import manifest, serve, stats
    c = manifest.load(ROOT, args.workload)
    dev = torch.device("cuda")
    deploy = c.adapter().build(c.sizes, c.cell, args.seeds[0], dev, None,
                               None)
    rows = []
    for rate, seed in [(r, s) for r in args.rates for s in args.seeds]:
        traffic = {**c.cell["traffic"], "rate": rate}
        rec = serve.run(deploy, traffic, seed, args.seconds,
                        traced=False, t_start=time.monotonic())
        reqs = rec.requests
        ok = sum(1 for r in reqs if r.status == "ok")
        lo = rec.window[0]
        third, end = (stats.outstanding(reqs, lo + args.seconds * f)
                      for f in (1 / 3, 1.0))
        by_bucket = {}
        for i in rec.infers:
            by_bucket.setdefault(i.bucket, []).append(i.seconds * 1e3)
        row = {"workload": args.workload, "rate": rate, "seed": seed,
               "sent": len(reqs),
               "ok_share": ok / max(len(reqs), 1),
               "goodput": stats.goodput(reqs, args.seconds),
               "p99_ms": stats.tail_ms(reqs), "outstanding_third": third,
               "outstanding_end": end,
               "batch_mean": sum(i.batch for i in rec.infers)
               / max(len(rec.infers), 1),
               "infers": len(rec.infers), "loads": len(rec.loads),
               "lag_p99_ms": stats.percentile(
                   [(r.sent - r.due) * 1e3 for r in reqs], 99.0),
               "infer_ms_p50_by_bucket": {
                   b: stats.percentile(v, 50) for b, v in sorted(
                       by_bucket.items())},
               "infers_by_bucket": {b: len(v) for b, v in
                                    sorted(by_bucket.items())},
               "sustained": ok >= 0.99 * len(reqs)
               and end <= third + rate * traffic["slo_ms"] / 1e3}
        rows.append(row)
        print(json.dumps(row), flush=True)
    knee = max((rate for rate in args.rates
                if all(r["sustained"] for r in rows if r["rate"] == rate)),
               default=None)
    print(json.dumps({"workload": args.workload, "knee": knee}), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows))


if __name__ == "__main__":
    main()
