"""Time the SSD scan's bf16 kernels at each head group on one CUDA card.

    PYTHONPATH=src python3 -m repro_torch.kernels.ssd_head_groups
    PYTHONPATH=src python3 -m repro_torch.kernels.ssd_head_groups --backward

The forward's output pass computes the head-independent scores C·Bᵀ once
per group of HG heads (``SSD_HEAD_GROUP`` in ``csrc/ssd_scan.cu``, 2 in the
library the port builds); so do the backward's two tile passes
(``SSD_BWD_HEAD_GROUP`` in ``csrc/ssd_scan_bwd.cu``, 2 in the port's
library; its key pass holds du's accumulators per head, so 4 does not fit
in registers). This builds the source at the other head groups beside the
port's library, checks each against the plain version at mamba2-130m's
shapes (the forward at the prefill shapes (1, 2048) and (4, 512), the
backward at the train path's (4, 1024) and (1, 2048), no final-state
cotangent), and prints, one JSON line per head group, the device ms per
call from CUDA-graph replay (the port's group timed first and last, so the
two readings give the spread within the run), each launch's device ms per
call from one torch.profiler session, the registers and spills of
the kernels that share C·Bᵀ (from ``-Xptxas -v``), and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ss

H, P, N, Q = 24, 64, 128, 256          # mamba2-130m
TOL = 4e-2                             # chip_smoke.py's bf16 SSD tolerance

# per source: its macro, the head groups timed (the port's own first), the
# shapes, and the kernels whose registers are printed
KERNELS = {
    "ssd_scan": dict(macro="SSD_HEAD_GROUP", groups=(2, 1, 4),
                     shapes=((1, 2048), (4, 512)),
                     ptxas=("ssd_chunk_output_bf16",)),
    "ssd_scan_bwd": dict(macro="SSD_BWD_HEAD_GROUP", groups=(2, 1),
                         shapes=((4, 1024), (1, 2048)),
                         ptxas=("ssd_bwd_keys_bf16", "ssd_bwd_queries_bf16")),
}


def graph_ms(fn, per_graph=20, replays=20):
    """Device ms per call: ``per_graph`` calls captured in one CUDA graph,
    replayed with CUDA events around the replays."""
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


def tensors(B, L, seed=1):
    """chip_smoke.py's draws: x, b, c ~ N(0, 0.25) in bf16, dt ~ U(0.01,
    0.2), a ~ -U(0.5, 2); then dy ~ N(0, 1) in bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((B, L, H, P), generator=g, device="cuda") * 0.5)
    dt = torch.rand((B, L, H), generator=g, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((H,), generator=g, device="cuda") * 1.5 + 0.5)
    b = torch.randn((B, L, N), generator=g, device="cuda") * 0.5
    c = torch.randn((B, L, N), generator=g, device="cuda") * 0.5
    dy = torch.randn((B, L, H, P), generator=g, device="cuda")
    return (x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16()), dy.bfloat16()


def defines(name, hg):
    """The build's defines for head group ``hg`` (none for the port's own)."""
    spec = KERNELS[name]
    return () if hg == spec["groups"][0] else (f"{spec['macro']}={hg}",)


def launch_ms(fn, calls=10):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        found = re.search(r"ssd_\w+", e.key)
        if us > 0 and found:
            out[found.group(0)] = us / 1e3 / calls
    return out


def calls(name, args, dy):
    """(kernel call, plain call) of ``name`` on one shape's inputs."""
    if name == "ssd_scan":
        return (lambda: ss.ssd_scan(*args, chunk=Q),
                lambda: ss.ssd_scan_plain(*args, chunk=Q))
    return (lambda: ss.ssd_scan_bwd(*args, dy, chunk=Q),
            lambda: ss.ssd_scan_bwd_plain(*args, dy, chunk=Q))


def max_err(got, want):
    """The largest error relative to each output's largest element."""
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp(min=1e-30)).item()
               for g, w in zip(got, want))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    name = "ssd_scan_bwd" if "--backward" in argv else "ssd_scan"
    if not torch.cuda.is_available():
        raise SystemExit("ssd_head_groups: no CUDA card")
    spec = KERNELS[name]
    groups = spec["groups"]
    with ThreadPoolExecutor(len(groups)) as pool:
        libs = dict(zip(groups, pool.map(
            lambda hg: build.build(name, defines(name, hg)), groups)))
    inputs = {shape: tensors(*shape) for shape in spec["shapes"]}
    want = {shape: calls(name, *io)[1]() for shape, io in inputs.items()}
    ms = {hg: {shape: [] for shape in spec["shapes"]} for hg in groups}
    passes = {hg: {} for hg in groups}
    errs = {}
    loaded = build._LOADED.get(name)
    try:
        for hg in groups + groups[:1]:
            # the wrappers launch through build.load(name): this variant
            # stands in for it while it is measured
            build._LOADED[name] = ctypes.CDLL(str(libs[hg]))
            for shape, io in inputs.items():
                kernel, _ = calls(name, *io)
                err = max_err(kernel(), want[shape])
                if not err <= TOL:
                    raise SystemExit(f"ssd_head_groups: {name} HG={hg} at "
                                     f"{shape}: error {err} of the largest "
                                     f"element, outside {TOL}")
                errs[hg] = max(errs.get(hg, 0.0), err)
                ms[hg][shape].append(graph_ms(kernel))
                if len(ms[hg][shape]) == 1:
                    passes[hg][shape] = launch_ms(kernel)
    finally:
        if loaded is None:
            build._LOADED.pop(name, None)
        else:
            build._LOADED[name] = loaded
    for hg in groups:
        print(json.dumps({
            "kernel": name, "head_group": hg, "H": H, "P": P, "N": N,
            "chunk": Q, "max_rel_err": errs[hg], "tolerance": TOL,
            "ms": {f"{B}x{L}": ms[hg][(B, L)] for B, L in spec["shapes"]},
            "launch_ms": {f"{B}x{L}": passes[hg][(B, L)]
                          for B, L in spec["shapes"]},
            "ptxas": build.kernel_resources(name, spec["ptxas"],
                                            defines(name, hg))}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi: no output", flush=True)


if __name__ == "__main__":
    main()
