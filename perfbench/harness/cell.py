"""One run of one cell, from set-up to the result line.

Set-up builds the cell's deployment (the adapter's ``build``), and in a
traced run counts each bucket's kernels per INFER under the profiler; the
serving stack then warms up on the cell's own traffic, measures for the
window and drains (``serve.run``). Once the window has closed the metrics
are read, the device's peak memory is taken, the program's state is freed,
and only then does the reference run, on the sampled outputs.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.harness import check, manifest, serve, stats
from perfbench.harness import trace as tr

JAX_NAMES = ("jax", "jaxlib", "flax", "repro")
NOT_FINITE = 1e300        # what the line prints for an infinite number
TOP = 10                  # entries of each breakdown list


def jax_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def _device(dev: torch.device, rec, peak: int) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1, "memory_peak_bytes": peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    if rec.trace is not None:
        out["busy_s"] = rec.trace.busy_s
        out["window_s"] = rec.trace.window_s
    return out


def _breakdown(trace) -> dict:
    ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


MIN_KERNEL_RATIO = 0.95   # a trace that recorded fewer lost device records
TRACED_WINDOWS = 2        # windows a traced run may serve to get one trace
KPI_TRIES = 3


def _validate_trace(rec, kpi, deploy, notes) -> None:
    """Keep the window's trace if its recorded kernels match what the
    window's INFERs launched (``kpi``: kernels per INFER by bucket, counted
    in set-up): ``rec.trace``, ``rec.traced_infers``. A session that lost
    its device records raises TraceError."""
    t, lo, hi, err = rec.window_trace
    mine = [i for i in rec.infers if lo <= i.t0 < hi]
    want = sum(kpi[i.bucket] for i in mine)
    if t is None:
        raise tr.TraceError(f"{err}; {want} kernels launched")
    ratio = t.kernels / want if want else None
    notes.append(
        f"trace: {t.kernels} device kernels recorded in the window, {want} "
        f"launched by its {len(mine)} INFERs (kernels per INFER by bucket "
        f"{kpi})" + (f": ratio {ratio:.4f}" if want else "")
        + f"; busy_s {t.busy_s:.6f} of window_s {t.window_s:.6f}")
    if want and ratio < MIN_KERNEL_RATIO:
        raise tr.TraceError(f"the session lost device records: {t.kernels} "
                            f"kernels of {want}")
    rec.trace, rec.traced_infers = t, mine
    for k, per in deploy.port_kernels_per_infer().items():
        notes.append(f"trace: {t.device_count(k)} {k} kernels recorded, "
                     f"{per * len(mine)} launched")


class Notes(list):
    """The lines a run prints before its result, echoed as they come (so
    that a run that fails still shows what it did)."""

    def __init__(self, echo=None):
        super().__init__()
        self.echo = echo

    def append(self, line: str):
        super().append(line)
        if self.echo is not None:
            print(line, file=self.echo, flush=True)

    def extend(self, lines):
        for line in lines:
            self.append(line)

    def __iadd__(self, lines):
        self.extend(lines)
        return self


class Outcome:
    """The result line, the lines printed before it on standard error, and
    (with ``control``) the control's numbers on the same samples and
    whether they pass the configuration's limits as the program's do."""

    def __init__(self, result: dict, notes: List[str],
                 control: Optional[Dict[str, float]] = None,
                 program: Optional[Dict[str, float]] = None,
                 summary: Optional[dict] = None,
                 control_correct: Optional[bool] = None):
        self.result, self.notes = result, notes
        self.control, self.program = control, program
        self.summary = summary
        self.control_correct = control_correct


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             *, device="cuda", overrides=None, t_start: Optional[float] = None,
             control: bool = False, reuse: Optional[dict] = None,
             fault=None, echo=None) -> Outcome:
    """One run. ``overrides`` (tests and ``tools/`` only) replace the
    configuration's sizes (``sizes``, at a tiny size on the CPU), the cell's
    ``instances`` and entries of its ``traffic``;
    ``control`` also reads the lower-precision control on the run's
    samples; ``reuse`` keeps engines across calls in one process
    (``tools/``); ``fault(deploy)`` (tests only) breaks the timed path
    after set-up; ``echo`` (a file) gets each note as it is made."""
    t_start = time.monotonic() if t_start is None else t_start
    c = manifest.load(Path(root), workload)
    dev = torch.device(device)
    notes = Notes(echo)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    over = overrides or {}
    cell = {**c.cell, **{k: over[k] for k in ("instances",) if k in over}}
    traffic = {**cell["traffic"], **over.get("traffic", {})}
    deploy = c.adapter().build(c.sizes, cell, seed, dev, over.get("sizes"),
                               reuse)
    kpi = None
    if traced:
        first = next(iter(deploy.engines.values()))
        for _ in range(KPI_TRIES):     # a session may drop device records
            kpi = serve.kernels_per_infer(first, deploy.buckets)
            if dev.type != "cuda" or all(kpi.values()):
                break
    if fault is not None:
        fault(deploy)
    for attempt in range(TRACED_WINDOWS if traced else 1):
        rec = serve.run(deploy, traffic, seed, seconds, traced=traced,
                        t_start=t_start)
        if not traced:
            break
        try:
            _validate_trace(rec, kpi, deploy, notes)
            break
        except tr.TraceError as e:
            # the profiler lost this window's device records (a session
            # now and then keeps almost none): serve another window
            notes.append(f"traced window {attempt}: {e}")
            if attempt == TRACED_WINDOWS - 1:
                raise
    n = len(rec.requests)
    statuses = {k: sum(1 for s in rec.requests if s.status == k)
                for k in ("ok", "timeout", "rejected", None)}
    ms = [i.seconds * 1e3 for i in rec.infers]
    notes.append(f"requests in the window: {n} sent, {statuses['ok']} ok, "
                 f"{statuses['timeout']} timed out, {statuses['rejected']} "
                 f"rejected, {statuses[None]} unanswered; "
                 f"{len(rec.infers)} INFERs (ms p50 "
                 f"{stats.percentile(ms, 50)}, p99 {stats.percentile(ms, 99)}"
                 f", max {max(ms, default=None)}), {len(rec.loads)} LOADs; "
                 f"setup_s {rec.setup_s:.3f}")
    summary = {"sent": n, **{str(k): v for k, v in statuses.items()},
               "infers": len(rec.infers), "loads": len(rec.loads),
               "batched": sum(1 for i in rec.infers if i.batch > 1),
               "setup_s": rec.setup_s,
               "outstanding": [stats.outstanding(rec.requests, t) for t in (
                   rec.window[0] + seconds / 3, rec.window[0] + seconds)]}
    metrics = {}
    for name, m in manifest.metrics(c, traced).items():
        v = c.reader(m)(rec)
        if v is not None:
            metrics[name] = {"value": v, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {"correct": False, "attempted": n,
              "failed": stats.unanswered(rec.requests), "metrics": metrics,
              "device": _device(dev, rec, peak)}
    if rec.trace is not None:
        result["breakdown"] = _breakdown(rec.trace)

    samples = rec.samples
    deploy.release()                       # the program's state goes first
    del rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    if control:
        triples = list(deploy.compare(samples, "f32"))
        found = check.numbers(triples)
        lower = [(s, lo, r) for (s, _, r), (_, _, lo) in
                 zip(triples, deploy.compare(samples, "fp8"))]
        ctrl = check.numbers(lower)
    else:
        found = check.numbers(deploy.compare(samples, "f32"))
        ctrl = None
    notes.append(f"reference: {found['rows']} sampled rows compared in "
                 f"{time.monotonic() - t0:.1f} s")
    limits = {**c.sizes, **over.get("sizes", {})}["limits"]
    chk = check.checks(found, limits, result["failed"])
    notes += [f"reported, not compared: {n} {found[n]}" for n in check.NAMES
              if n not in chk]
    for v in chk.values():
        v["value"] = _finite(v["value"])
    bad = jax_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{bad}")
    result["correct"] = bool(found["rows"]) and check.passed(chk)
    if not found["rows"]:
        notes.append("no answered row was sampled: nothing was compared")
    result["checks"] = chk
    notes += [f"check {k}: {v['value']} (limit {v['limit']})"
              for k, v in chk.items()]
    ctrl_ok = None
    if ctrl is not None:        # judged as the program is, on the same rows
        ctrl_ok = bool(ctrl["rows"]) and check.passed(
            check.checks(ctrl, limits, 0))
    return Outcome(result, notes, control=ctrl, program=found,
                   summary=summary, control_correct=ctrl_ok)
