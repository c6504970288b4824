"""Load-generator process: `python -m repro_torch.runtime.loadgen`.

The third tier of the paper's topology (workload | controller | workers,
§6): drives the seeded generators from `serving/workload.py` through a
`RemoteClient` against a remote controller over TCP, and reports
*client-observed* goodput and latency percentiles at exit — SLO
attainment measured on the client's side of the network, where the paper
measures it.

One process is one connection (RealClock EventLoop + RealtimePump +
TcpChannel). `--processes N` forks N child loadgens with spread seeds
and aggregates their results — a multi-process open/closed/MAF workload
front end, so the client tier scales independently of the controller.

Output: exactly one JSON object on stdout (machine-readable; the
three-process demo and CI smoke parse it), human progress on stderr.

    python -m repro_torch.runtime.loadgen --controller 127.0.0.1:9000 \
        --workload open --rate 20 --duration 3 --processes 2
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.core.clock import EventLoop, RealClock, RealtimePump
from repro_torch.runtime.client import RemoteClient
from repro_torch.runtime.transport import tcp_connect
from repro_torch.serving.workload import WORKLOAD_KINDS, build_workload
from repro_torch.telemetry.recorder import Recorder
from repro_torch.telemetry.reports import quantile


def model_ids(n_models: int):
    """Names of the shared demo model set (`runtime.worker.demo_models`):
    both sides of the TCP demo must agree on them."""
    return [f"m{i}" for i in range(n_models)]


def _connect_with_retry(host: str, port: int, post, deadline: float):
    t0 = time.monotonic()
    while True:
        try:
            return tcp_connect(host, port, post)
        except OSError:
            if time.monotonic() - t0 >= deadline:
                raise
            time.sleep(0.1)


def _run_single(args) -> dict:
    host, _, port = args.controller.rpartition(":")
    loop = EventLoop(RealClock())
    pump = RealtimePump(loop, max_poll=0.005)
    recorder = Recorder()
    if args.telemetry_jsonl:
        recorder.stream_to(args.telemetry_jsonl,
                           rotate_bytes=args.rotate_bytes)
    channel = _connect_with_retry(host, int(port), pump.post,
                                  args.connect_timeout)
    client = RemoteClient(loop, channel, recorder=recorder)
    start = loop.now()
    gens = build_workload(loop, client.submit, model_ids(args.n_models),
                          kind=args.workload, slo=args.slo, rate=args.rate,
                          concurrency=args.concurrency, start=start,
                          duration=args.duration, seed=args.seed,
                          total_rate=args.total_rate)
    client.attach(gens)
    print(f"[loadgen] driving {args.workload} workload for "
          f"{args.duration}s against {args.controller}",
          file=sys.stderr, flush=True)
    pump.run(timeout=args.duration + 0.05)
    # generators have stopped; wait for the tail of in-flight responses
    pump.run(until=lambda: client.in_flight == 0, timeout=args.drain)
    client.close()
    recorder.close_stream()

    out = client.summary()
    out["report"] = client.report()
    if args.emit_latencies:
        out["latencies"] = client.latencies
    return out


def _child_cmd(args, i: int) -> list:
    """Child loadgen command, rebuilt from parsed args (immune to the
    --flag=value vs --flag value spelling of the parent's argv): single
    process, spread seed, raw latencies for exact percentile merging."""
    cmd = [sys.executable, "-m", "repro_torch.runtime.loadgen",
           "--controller", args.controller, "--workload", args.workload,
           "--n-models", str(args.n_models), "--rate", str(args.rate),
           "--concurrency", str(args.concurrency), "--slo", str(args.slo),
           "--duration", str(args.duration), "--drain", str(args.drain),
           "--connect-timeout", str(args.connect_timeout),
           "--processes", "1", "--seed", str(args.seed + 1000 * i),
           "--emit-latencies"]
    if args.total_rate is not None:
        cmd += ["--total-rate", str(args.total_rate)]
    if args.telemetry_jsonl:
        cmd += ["--telemetry-jsonl", f"{args.telemetry_jsonl}.{i}"]
    if args.rotate_bytes is not None:
        cmd += ["--rotate-bytes", str(args.rotate_bytes)]
    return cmd


def _run_parent(args) -> dict:
    """Fan out N child loadgens (spread seeds), aggregate their JSON."""
    procs = [subprocess.Popen(_child_cmd(args, i), env=dict(os.environ),
                              stdout=subprocess.PIPE, text=True)
             for i in range(args.processes)]
    outs, rcs = [], []
    for pr in procs:
        try:
            stdout, _ = pr.communicate(
                timeout=args.duration + args.drain + 60)
        except subprocess.TimeoutExpired:
            pr.kill()
            stdout, _ = pr.communicate()
        rcs.append(pr.returncode)
        if pr.returncode == 0:
            outs.append(json.loads(stdout))
    lats = sorted(x for o in outs for x in o.get("latencies", ()))
    agg = {k: sum(o[k] for o in outs)
           for k in ("sent", "goodput", "timeout", "rejected",
                     "in_flight", "lost")}
    agg.update(p50=quantile(lats, 0.50), p99=quantile(lats, 0.99),
               child_returncodes=rcs,
               children=[{k: v for k, v in o.items() if k != "latencies"}
                         for o in outs])
    return agg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.loadgen",
        description="Clockwork load generator: drives seeded open/closed/"
                    "MAF workloads through a remote SUBMIT/RESPONSE client "
                    "and reports client-observed goodput + latency.")
    p.add_argument("--controller", required=True, metavar="HOST:PORT")
    p.add_argument("--workload", choices=WORKLOAD_KINDS, default="open")
    p.add_argument("--n-models", type=int, default=4,
                   help="size of the shared demo model set (m0..m{n-1})")
    p.add_argument("--rate", type=float, default=20.0,
                   help="per-model open-loop rate (r/s)")
    p.add_argument("--total-rate", type=float, default=None,
                   help="maf: total rate split across models "
                        "(default rate * n_models)")
    p.add_argument("--concurrency", type=int, default=4,
                   help="closed-loop outstanding requests per model")
    p.add_argument("--slo", type=float, default=0.25)
    p.add_argument("--duration", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--processes", type=int, default=1,
                   help="fork this many child loadgens (spread seeds) "
                        "and aggregate their results")
    p.add_argument("--drain", type=float, default=2.0,
                   help="extra seconds to wait for in-flight responses")
    p.add_argument("--connect-timeout", type=float, default=10.0)
    p.add_argument("--telemetry-jsonl", default=None,
                   help="stream client-side spans to this JSONL file")
    p.add_argument("--rotate-bytes", type=int, default=None)
    p.add_argument("--emit-latencies", action="store_true",
                   help="include raw latency samples in the JSON output "
                        "(the parent process uses this for exact "
                        "percentile aggregation)")
    args = p.parse_args(argv)

    if args.processes > 1:
        out = _run_parent(args)
        ok = all(rc == 0 for rc in out["child_returncodes"])
    else:
        out = _run_single(args)
        ok = True
    print(f"[loadgen] goodput={out['goodput']}/{out['sent']} "
          f"p50={out['p50'] * 1e3:.1f}ms p99={out['p99'] * 1e3:.1f}ms "
          f"timeout={out['timeout']} rejected={out['rejected']}",
          file=sys.stderr, flush=True)
    print(json.dumps(out, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
