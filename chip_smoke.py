#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, count and power limit (nvidia-smi).
2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc for
             sm_90a; prints each kernel's registers, shared memory and spills.
3. kernels — each kernel against its plain PyTorch version on the card over
             the reference's decode cases (f32 and bf16), a gemma2-style
             window + softcap + ring case and the qwen2-0.5b serving shapes;
             then kernel, plain and library (SDPA) times: device time from
             CUDA-graph replay and time per eager call, with CUDA events.
4. serve   — full-width qwen2-0.5b (24 layers, d_model 896, vocab 151936,
             random weights from a seed) served by a Clockwork Controller and
             one Worker over TorchBackend on a RealClock; checks answers and
             that every INFER went through the kernel (24 launches each);
             then INFER time per bucket and a torch.profiler breakdown.

Then the {"kernels": [...]} summary, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure exits nonzero before that.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# tests/test_kernels.py::DECODE_CASES (B, S, H, K, D, window, ring) with cur
# 25, no softcap; then a gemma2-style local layer (window 16 = S: a ring,
# softcap 50) with cur inside and past the window; then the largest head
# (G=16, D=256), whose tiles need more than 48 KB of shared memory.
DECODE_CASES = [
    (2, 40, 4, 2, 32, 0, False, 0.0, 25),
    (1, 32, 2, 1, 16, 8, True, 0.0, 25),
    (2, 64, 8, 2, 64, 0, False, 0.0, 25),
    (1, 48, 4, 4, 128, 16, True, 0.0, 25),
    (2, 16, 8, 4, 128, 16, True, 50.0, 10),
    (2, 16, 8, 4, 128, 16, True, 50.0, 40),
    (2, 256, 32, 2, 256, 0, False, 0.0, 200),
]
# qwen2-0.5b at the published widths: K=2 kv-heads, G=7, D=64, bf16. ctx 128
# with cur 64 is what the serving engine runs, at each of its batch buckets;
# 4096 is a long full cache.
CTX, CUR = 128, 64
BUCKETS = (1, 2, 4, 8)
SERVE_SHAPES = ([(b, CTX, CUR) for b in BUCKETS]
                + [(1, 4096, 4095), (8, 4096, 4095)])
# traffic as tests/test_system.py::test_real_jax_serving_roundtrip: one
# request every 20 ms, SLO 5 s
N_REQUESTS, GAP_S, SLO_S = 30, 0.02, 5.0
# INFERs per bucket in the dedicated sweep: enough for a p99 to be more than
# the maximum
SWEEP_REPS = 200


def emit(obj):
    print(json.dumps(obj), flush=True)


def die(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def cuda_ms(fn, iters, warmup=10):
    """ms per call of back-to-back eager calls, CUDA events around them: the
    device time, or the host's enqueue time where that is the longer."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, per_graph=20, replays=20):
    """Device ms per call: ``per_graph`` calls captured in one CUDA graph,
    replayed with CUDA events around the replays (no host work between
    launches)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


# --------------------------------------------------------------- phases

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        die("device", f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    info = {"phase": "device", "ok": True,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = {name: build.build(name) for name in build.sources()}
    secs = time.perf_counter() - t0
    ptxas = {name: [l.strip() for l in build.build_log(name).splitlines()
                    if "registers" in l or "spill" in l or "Compiling" in l]
             for name in libs}
    emit({"phase": "build", "ok": True, "seconds": secs,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas": ptxas})


def _case_tensors(case, dtype, seed=0):
    import torch
    B, S, H, K, D, window, ring, cap, cur = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    kpos = torch.arange(S, dtype=torch.int32, device="cuda")
    if ring:
        kpos = cur - torch.remainder(cur - kpos, S)
    return q, k, v, kpos


def _check_case(case, dtype):
    import torch
    from repro_torch.kernels import flash_decode as fd
    q, k, v, kpos = _case_tensors(case, getattr(torch, dtype))
    window, cap, cur = case[5], case[7], case[8]
    got = fd.flash_decode(q, k, v, kpos, cur, window=window, cap=cap)
    torch.cuda.synchronize()
    want = fd.flash_decode_plain(q, k, v, kpos, cur, window=window, cap=cap)
    err = (got.float() - want.float()).abs().max().item()
    if not (err <= TOL[dtype]) or not torch.isfinite(got).all().item():
        die("kernels", f"flash_decode {case} {dtype}: max abs err {err} "
                       f"> {TOL[dtype]} (or non-finite)")
    return err


def _time_shape(B, S, cur):
    """Kernel, plain and SDPA times at one qwen2-0.5b serving shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.utils import H100
    K, G, D = 2, 7, 64
    H = K * G
    case = (B, S, H, K, D, 0, False, 0.0, cur)
    q, k, v, kpos = _case_tensors(case, torch.bfloat16, seed=1)
    kernel = lambda: fd.flash_decode(q, k, v, kpos, cur)           # noqa: E731
    plain = lambda: fd.flash_decode_plain(q, k, v, kpos, cur)      # noqa: E731
    # yardstick only: one library call computing the same function
    qs = q[:, :, None, :]                                     # (B,H,1,D)
    ks = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vs = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    mask = ((kpos >= 0) & (kpos <= cur))[None, None, None, :]
    library = lambda: F.scaled_dot_product_attention(                # noqa: E731
        qs, ks, vs, attn_mask=mask)
    times = {}
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        times[name + "ms"] = graph_ms(fn)
        times[name + "eager_ms"] = cuda_ms(fn, 200)
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)[:, :, 0]
    lib_err = (lib_out.float() - fd.flash_decode(q, k, v, kpos, cur).float()
               ).abs().max().item()
    # least time for the same work: each input read once, the output written
    # once, over the keys this data needs (kpos <= cur)
    n_keys = int(((kpos >= 0) & (kpos <= cur)).sum().item())
    bytes_moved = (2 * B * H * D * 2                   # q in, out
                   + 2 * B * n_keys * K * D * 2        # K and V rows
                   + S * 4)                            # kpos
    ops = 4 * B * H * n_keys * D                       # QK^T and PV
    t_bytes = bytes_moved / H100.hbm_bandwidth * 1e3
    t_ops = ops / H100.peak_bf16_flops * 1e3
    return {"B": B, "S": S, "cur": cur, "K": K, "G": G, "D": D,
            "dtype": "bfloat16", **times, "library_max_abs_err": lib_err,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "operations": ops}


def phase_kernels():
    errs = []
    for case in DECODE_CASES:
        for dtype in ("float32", "bfloat16"):
            errs.append(_check_case(case, dtype))
    serve_errs = []
    for B, S, cur in SERVE_SHAPES:
        serve_errs.append(_check_case((B, S, 14, 2, 64, 0, False, 0.0, cur),
                                      "bfloat16"))
    shapes = [_time_shape(B, S, cur) for B, S, cur in SERVE_SHAPES]
    res = {"phase": "kernels", "ok": True, "kernel": "flash_decode",
           "cases_checked": len(errs) + len(serve_errs),
           "max_abs_err_cases": max(errs), "max_abs_err_serving": max(serve_errs),
           "tolerance": TOL, "shapes": shapes}
    emit(res)
    return res


def _spread(secs):
    """n, p50, p99 and max in ms, and the coefficient of variation
    (std/mean). Under 100 samples the p99 is all but the max: read the max."""
    import numpy as np
    a = np.asarray(secs, dtype=np.float64)
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)) * 1e3,
            "p99_ms": float(np.percentile(a, 99)) * 1e3,
            "max_ms": float(a.max()) * 1e3, "cv": float(a.std() / a.mean())}


def _served_stats(controller, model_id):
    per_b = {}
    for rec in controller.recorder.iter_actions():
        if rec.action_type == "INFER" and rec.status == "SUCCESS":
            per_b.setdefault(rec.batch_size, []).append(rec.actual)
    return {str(b): {**_spread(xs), "profile_ms": controller.profiler.estimate(
                "INFER", model_id, b) * 1e3}
            for b, xs in sorted(per_b.items())}


def _check_logits(logits, cfg, batch):
    import torch
    want = (batch, 1, cfg.vocab_padded)
    if tuple(logits.shape) != want:
        die("serve", f"logits shape {tuple(logits.shape)} != {want}")
    real = logits[..., :cfg.vocab_size]
    if not torch.isfinite(real).all().item():
        die("serve", "non-finite logits")
    if cfg.vocab_padded > cfg.vocab_size and not (
            logits[..., cfg.vocab_size:] == torch.finfo(torch.float32).min).all():
        die("serve", "padded vocab entries are not masked")


def _check_against_cpu():
    """The smoke-size qwen2-0.5b decode on the card (kernel) against the same
    weights and cache on the CPU (plain version). The logits, and the new
    token's K and V written at slot CUR of every layer, each within
    2e-2 x max(|its ref|, 1), as tests/test_torch_lm.py holds bf16 (cuBLAS
    and the CPU round bf16 matmul outputs differently); every other slot is
    left bit for bit as it was."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_map
    cfg = get_smoke_config("qwen2-0.5b")
    bundle = get_bundle(cfg)
    gen = torch.Generator().manual_seed(1)
    params = bundle.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen)
    cache0 = tree_map(lambda t: torch.randn(t.shape, generator=gen).to(t.dtype),
                      bundle.init_cache(4, CTX, device="cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        cache = tree_map(lambda t: t.to(dev, copy=True), cache0)
        with torch.inference_mode():
            logits, cache = bundle.decode(p, cache, tokens.to(dev), CUR)
        out[dev] = (logits.float().cpu(),
                    {n: cache["stack"][0]["kv"][n].cpu() for n in ("k", "v")})
    V = cfg.vocab_size
    ref, got = out["cpu"], out["cuda"]
    err = (got[0][..., :V] - ref[0][..., :V]).abs().max().item()
    tol = 2e-2 * max(ref[0][..., :V].abs().max().item(), 1.0)
    if not (err <= tol and torch.equal(got[0][..., V:], ref[0][..., V:])):
        die("serve", f"smoke decode on the card vs CPU: logits {err} > {tol}")
    res = {"logits_max_abs_err": err, "logits_tol": tol}
    before = cache0["stack"][0]["kv"]
    others = [s for s in range(CTX) if s != CUR]    # (layers, B, S, K, D)
    for n in ("k", "v"):
        new_ref = ref[1][n][:, :, CUR].float()
        new_err = (got[1][n][:, :, CUR].float() - new_ref).abs().max().item()
        new_tol = 2e-2 * max(new_ref.abs().max().item(), 1.0)
        kept = all(torch.equal(side[n][:, :, others], before[n][:, :, others])
                   for side in (ref[1], got[1]))
        if not (new_err <= new_tol and kept):
            die("serve", f"smoke decode on the card vs CPU: new {n} at slot "
                         f"{CUR} {new_err} > {new_tol}, or other slots changed")
        res[f"cache_{n}_max_abs_err"] = new_err
        res[f"cache_{n}_tol"] = new_tol
    return res


def _profile_infer(jm, b):
    """One INFER of bucket ``b`` under torch.profiler: its wall time, the
    device time its kernels sum to, and how many kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = jm.run(b)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) for e in dev)
    top = sorted(dev, key=lambda e: -getattr(e, "self_device_time_total", 0))[:8]
    return {"bucket": b, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3 if dev else None,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3) if dev else None,
            "kernels": sum(e.count for e in dev),
            "top_kernels": [{"name": e.key[:60], "count": e.count,
                             "ms": getattr(e, "self_device_time_total", 0) / 1e3}
                            for e in top]}


def phase_serve():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.actions import Request
    from repro_torch.core.clock import EventLoop, RealClock
    from repro_torch.core.controller import Controller
    from repro_torch.core.scheduler import ClockworkScheduler
    from repro_torch.core.worker import Worker
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serving.engine import TorchBackend, make_lm_decode_model

    smoke = _check_against_cpu()

    class CountingBackend(TorchBackend):
        infers = 0

        def exec_duration(self, model, action):
            self.infers += 1
            return super().exec_duration(model, action)

    model_id = "qwen2_decode"
    t0 = time.perf_counter()
    jm = make_lm_decode_model(model_id, full=True, batches=BUCKETS,
                              ctx=CTX, seed=0)
    t_init = time.perf_counter() - t0
    cfg = get_config("qwen2-0.5b")
    n_layers = cfg.num_layers
    load_s = jm.load()
    t0 = time.perf_counter()
    jm.compile()
    t_compile = time.perf_counter() - t0
    with torch.inference_mode():
        for b in jm.batches:
            _check_logits(jm.forward(jm.device_params, jm.make_input(b)), cfg, b)
    models = {model_id: jm.modeldef()}           # measured INFER profiles
    profiles = jm.seed_profiles()
    backend = CountingBackend({model_id: jm})
    loop = EventLoop(RealClock())
    worker = Worker("w0", loop, backend, models, n_gpus=1)
    controller = Controller(loop, models, ClockworkScheduler(),
                            action_delay=1e-4)
    controller.add_worker(worker, profiles=profiles)
    done = []
    controller.on_response = done.append

    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode.launches = 0                 # the main path's run starts
    backend.infers = 0
    n_req = N_REQUESTS
    for _ in range(n_req):
        controller.on_request(Request(model_id=model_id, arrival=loop.now(),
                                      slo=SLO_S))
        loop.run_until(loop.now() + GAP_S)
    loop.run_until(loop.now() + 3.0)
    launches = fd.flash_decode.launches          # ... and ends
    infers = backend.infers

    ok = [r for r in done if r.status == "ok"]
    lat = [(r.completion - r.arrival) for r in ok]
    res = {"phase": "serve", "model": "qwen2-0.5b", "layers": n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "weights_bytes": jm.weights_bytes, "init_s": t_init,
           "load_s": load_s, "compile_s": t_compile,
           "requests": n_req, "responses": len(done), "ok_responses": len(ok),
           "statuses": sorted({r.status for r in done}),
           "infer_actions": infers, "flash_decode_launches": launches,
           "launches_per_infer": launches / infers if infers else None,
           "latency": _spread(lat),
           "slo_s": SLO_S,
           "exec_by_bucket": _served_stats(controller, model_id),
           "profiles_ms": {str(b): profiles[("INFER", model_id, b)] * 1e3
                           for b in jm.batches},
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "smoke_card_vs_cpu": smoke}
    res["ok"] = (len(ok) >= 0.9 * n_req and infers > 0
                 and launches == n_layers * infers)
    # a dedicated sweep for the spread of execution time per bucket (Fig. 2)
    sweep = jm.measure(reps=SWEEP_REPS)
    res["sweep_by_bucket"] = {str(b): _spread(d) for (_, b), d in sweep.items()}
    res["profiled_infers"] = [_profile_infer(jm, b) for b in (1, 8)]
    emit(res)
    if not res["ok"]:
        die("serve", f"{len(ok)}/{n_req} ok, {launches} launches for "
                     f"{infers} INFERs ({n_layers} per INFER expected)")
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    serve = phase_serve()
    # the kernel's times at the shape the main path's run launched it at
    # most: its most served bucket, the engine's ctx
    served = serve["exec_by_bucket"]
    main_b = max(served, key=lambda b: served[b]["n"])
    main_shape = next(s for s in kern["shapes"]
                      if (s["B"], s["S"]) == (int(main_b), CTX))
    emit({"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:67",
        "launches": serve["flash_decode_launches"],
        "launches_per_infer": serve["launches_per_infer"],
        "max_abs_err": kern["max_abs_err_serving"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "eager_ms": main_shape["eager_ms"],
        "plain_eager_ms": main_shape["plain_eager_ms"],
        "library_eager_ms": main_shape["library_eager_ms"],
        "shape": {k: main_shape[k] for k in ("B", "S", "cur", "K", "G", "D",
                                             "dtype")}}]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
