"""Time ``ssd_scan``'s bf16 kernel at each head group on one CUDA card.

    PYTHONPATH=src python3 -m repro_torch.kernels.ssd_head_groups

The output pass computes the head-independent scores C·Bᵀ once per group of
HG heads (``SSD_HEAD_GROUP`` in ``csrc/ssd_scan.cu``, 2 in the library the
port builds). This builds the source at HG = 1 and 4 beside the port's
library, checks all three against the plain version at mamba2-130m's
prefill shapes (1, 2048) and (4, 512), and prints, one JSON line per head
group, the device ms per call from CUDA-graph replay (HG = 2 timed first
and last, so the two readings give the spread within the run), the output
kernel's registers and spills from ``-Xptxas -v``, and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as ss

HEAD_GROUPS = (1, 2, 4)
ORDER = (2, 1, 4, 2)
SHAPES = ((1, 2048), (4, 512))
H, P, N, Q = 24, 64, 128, 256          # mamba2-130m
TOL = 4e-2                             # chip_smoke.py's bf16 SSD tolerance


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
    0.2), a ~ -U(0.5, 2)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((B, L, H, P), generator=g, device="cuda") * 0.5)
    dt = torch.rand((B, L, H), generator=g, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((H,), generator=g, device="cuda") * 1.5 + 0.5)
    b = torch.randn((B, L, N), generator=g, device="cuda") * 0.5
    c = torch.randn((B, L, N), generator=g, device="cuda") * 0.5
    return (x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16())


def defines(hg):
    """The build's defines for head group ``hg`` (none for the port's own)."""
    return () if hg == 2 else (f"SSD_HEAD_GROUP={hg}",)


def output_kernel_ptxas(hg):
    """Registers and spill bytes of ssd_chunk_output_bf16 at P=64, N=128."""
    log = build.library_path("ssd_scan", defines(hg)
                             ).with_suffix(".log").read_text()
    # from the kernel's "Compiling entry function" line to the next one
    # (ptxas's notes name the kernel earlier too)
    mangled = f"ssd_chunk_output_bf16ILi{P}ELi{N}ELi{hg}E"
    entry = re.search(r"Compiling entry function '[^']*" + mangled
                      + r"[^']*'(.*?)(?=Compiling entry|\Z)", log, re.S)
    block = entry.group(1) if entry else ""
    regs = re.search(r"Used (\d+) registers", block)
    spill = re.search(r"(\d+) bytes spill stores", block)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spill.group(1)) if spill else None}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssd_head_groups: no CUDA card")
    with ThreadPoolExecutor(len(HEAD_GROUPS)) as pool:
        libs = dict(zip(HEAD_GROUPS, pool.map(
            lambda hg: build.build("ssd_scan", defines(hg)), HEAD_GROUPS)))
    inputs = {shape: tensors(*shape) for shape in SHAPES}
    want = {shape: ss.ssd_scan_plain(*args, chunk=Q)
            for shape, args in inputs.items()}
    ms = {hg: {shape: [] for shape in SHAPES} for hg in HEAD_GROUPS}
    errs = {}
    loaded = build._LOADED.get("ssd_scan")
    try:
        for hg in ORDER:
            # ss.ssd_scan launches through build.load("ssd_scan"): this
            # variant stands in for it while it is measured
            build._LOADED["ssd_scan"] = ctypes.CDLL(str(libs[hg]))
            for shape, args in inputs.items():
                y, state = ss.ssd_scan(*args, chunk=Q)
                err = max((y.float() - want[shape][0].float()).abs().max().item(),
                          (state - want[shape][1]).abs().max().item())
                if not (torch.allclose(y.float(), want[shape][0].float(),
                                       rtol=TOL, atol=TOL)
                        and torch.allclose(state, want[shape][1], rtol=TOL,
                                           atol=TOL)):
                    raise SystemExit(f"ssd_head_groups: HG={hg} at {shape}: "
                                     f"max abs err {err} outside {TOL}")
                errs[hg] = max(errs.get(hg, 0.0), err)
                ms[hg][shape].append(graph_ms(
                    lambda args=args: ss.ssd_scan(*args, chunk=Q)))
    finally:
        if loaded is None:
            build._LOADED.pop("ssd_scan", None)
        else:
            build._LOADED["ssd_scan"] = loaded
    for hg in HEAD_GROUPS:
        print(json.dumps({
            "kernel": "ssd_scan", "head_group": hg, "H": H, "P": P, "N": N,
            "chunk": Q, "max_abs_err": errs[hg], "tolerance": TOL,
            "ms": {f"{B}x{L}": ms[hg][(B, L)] for B, L in SHAPES},
            **output_kernel_ptxas(hg)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi: no output", flush=True)


if __name__ == "__main__":
    main()
