#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (the kernels phase one per kernel, the
prefill phase one per model):

1. device  — the card's name, count and power limit (nvidia-smi).
2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc for
             sm_90a, one nvcc per source, all started together; prints each
             kernel's registers, shared memory and spills.
3. kernels — each kernel against its plain PyTorch version on the card, in
             f32 and bf16: flash_decode over the reference's decode cases, a
             gemma2-style window + softcap + ring case, small cases of the
             fourth slice's heads (G=10 at D=256 in a ring, a cross cache,
             G=16), the qwen2-0.5b serving shapes and each prefill path's
             first decode step; flash_attention over the reference's
             ATTN_CASES, a gemma2-style window + softcap case, D=256, D=80,
             small fourth-slice cases (G=10 at D=256 windowed, cross with
             Sq != Skv, G=16) and every prefill path's shapes (ATTN_TIMED);
             the attention backward (flash_attention_bwd: the forward
             kernel's out and lse, then dq, dk and dv against
             flash_attention_bwd_plain) over ATTN_CASES in f32 and bf16,
             the train path's qwen2-0.5b shapes and every timed shape in
             bf16, then repeated bf16 calls bit for bit (BWD_REPEAT);
             ssd_scan over the
             reference's SSD_CASES and the mamba2-130m prefill shapes; the
             SSD backward (ssd_scan_bwd against ssd_scan_bwd_plain, with
             and without a final-state cotangent) over SSD_BWD_CASES in f32
             and bf16 and at the train path's mamba2-130m shapes, then
             repeated bf16 calls bit for bit. The
             count of HGMMA (wgmma) instructions in the built
             flash_attention, flash_attention_bwd, ssd_scan and
             ssd_scan_bwd libraries (cuobjdump; the run dies at 0), and of
             HMMA (mma.sync) ones; the registers and spills of the SSD
             backward's tensor-core kernels (ptxas). Then
             kernel, plain and library times at the main paths' shapes:
             device time from CUDA-graph replay and time per eager call,
             with CUDA events, and the achieved TFLOP/s, GB/s and share of
             the bound (for the backward the library is SDPA's backward
             under autograd, eager, in turns with the eager kernel, and
             the forward is timed with lse written and without); for
             ssd_scan and ssd_scan_bwd also, from profiled calls, the
             device kernels per call and each pass's device time, and the
             forward's head group in use. No PyTorch call computes the SSD
             scan or its backward: no library time. Then the
             segment-parallel context attention's kernel changes
             (SEG_SPLITS): flash_attention with a key offset k0 per
             segment against its plain version on the rows that see a key
             (ATTN_CASES in f32 and bf16, qwen2-0.5b at (1, 2048) and
             recurrentgemma's windowed (1, 3072), in 2 and 16 segments), the
             segments merged by lse against the unsegmented kernel and the
             plain version, each segment's backward (from the merged out
             and lse) against the unsegmented backward's slices and the sum
             of the segments' dq against its dq at (4, 256) and (1, 2048),
             and flash_decode's rows' lse with the cache cut into 2 and 16
             shards, merged, against the unsplit kernel; times of the 16
             segment calls beside the whole call, forward and backward, of
             the last segment alone (plain version, SDPA with its mask,
             bound) and of one decode shard with and without lse; ssd_scan
             also at the train step's (4, 1024).
4. prefill — the prefill -> decode path of every family at full width
             (random weights from a seed): qwen2-0.5b and mamba2-130m at
             (B, S) = (1, 2048) and (4, 512); recurrentgemma-2b also at
             (1, 3072), past its 2048 window; qwen3-moe-235b-a22b (depth cut
             to 4 layers); seamless-m4t-medium (frames, then min(1024, S)
             decoder tokens); llava-next-mistral-7b at 4096 and 3072 rows,
             2880 of them image rows. Each make_prefill_step, then 16 greedy
             make_decode_step steps from the prefilled length; checks the
             launches (flash_attention once per attention layer, encoder and
             cross layers included, per prefill; ssd_scan per Mamba2 layer;
             flash_decode per self and cross attention layer per decode
             step), the decode_matches_full_forward identity at full width
             for the decoder-only paths (with qwen3-moe's routing flips
             against the train forward), and smoke-size prefill -> decode on
             the card against the CPU (llama4-maverick too, at smoke size
             only); then prefill ms per shape and a torch.profiler breakdown
             per model.
5. train   — full-width qwen2-0.5b, then mamba2-130m, training (random
             weights from seed 0, AdamW, 2 microbatches, remat) through
             repro_torch.launch.train.train at (B, S) = (8, 256) for qwen2,
             (8, 1024) for mamba2 (4 chunks of 256 a sequence), for 8 steps
             with a checkpoint every 4, on the seeded synthetic stream;
             checks the launches per step (qwen2: flash_attention 96, 24
             layers x 2 microbatches x forward and remat recompute,
             flash_attention_bwd 48; mamba2: ssd_scan 96 and ssd_scan_bwd
             48, no attention), then resumes from the step-4
             checkpoint to the same step-8 loss within 1e-3; reads the
             gradient norm of the main path's first step on its own
             weights (under the reference's init the loss does not move in
             a few steps at full width); then, from the same weights with
             the head projections at 1/sqrt(d_model), 5 steps on one
             batch, timed (step ms, tokens/s, peak device memory; the loss
             must fall by 0.5) and one profiled (device busy, idle share,
             device time by kind, the largest kernels), 2 steps at
             (2, 2048), and one smoke-size train step on the card against
             the CPU (gemma2-27b for qwen2: window + softcaps, Adafactor;
             mamba2-130m's own): in f32 on the reference's init, and in
             bf16 on conditioned weights against the CPU's f32 step, every
             leaf's gradient and weights.
6. sharded — the same paths through the mesh code
             (distributed/steps.py::build_sharded_step): NCCL with one
             rank, a (1, 1) ("data", "model") mesh on the card, every
             placement Replicate. Full-width qwen2-0.5b on the train phase's
             conditioned weights: 3 sharded train steps at (8, 256) against
             make_train_step from the same weights (each step's loss and
             gradient norm, the final weights and optimizer state, bit for
             bit; 96 flash_attention and 48 flash_attention_bwd launches a
             step), a prefill at (1, 2048) and 16 greedy decode steps
             against the plain steps (every token and the final cache, bit
             for bit; 24 flash_attention, 24 flash_decode a step); then
             mamba2-130m's 2 train steps at (8, 1024) (96 ssd_scan and 48
             ssd_scan_bwd a step), and launch.train.train(mesh_shape=(1, 1))
             for 4 steps with a checkpoint at 2, its losses against the
             train phase's plain launcher's and its resume from step 2, bit
             for bit. Each with the sharded and the plain steps' times,
             alternating (DTensor's host cost). The vocab-parallel layer
             (distributed/vocab.py; no mesh with a model axis of more than
             one rank runs on one card): qwen2-0.5b's table and one (8,
             256) train batch's f32 logits cut into 16 vocab shards, the
             per-shard bodies merged as the collectives merge them, against
             the plain lookup (bit for bit) and the plain loss and logits
             gradient (f32, 2e-4 relative), two calls bit for bit, and the
             device ms of both, in turns. Then full-width qwen3-moe
             cut to 4 layers through the mesh, where MoE takes the
             expert-parallel path (capacity dispatch, drops): a prefill at
             (1, 2048) and (4, 512) and 16 greedy decode steps (launches,
             the dropped pairs of each call), one MoE block against a
             masked-dense version with the same drop table (bf16 2e-2),
             two calls bit for bit, a token with no dropped pair bit for
             bit at 2048, 2049 and 1 tokens, each 64-row block of one
             batched expert product bit for bit against a product of that
             block alone at 1 to 80 blocks, and the device time of the 4
             blocks' expert GEMMs, expert-parallel beside dense, in turns.
             The group is destroyed however the phase ends.
7. serve   — full-width qwen2-0.5b (24 layers, d_model 896, vocab 151936,
             random weights from a seed) served by a Clockwork Controller and
             one Worker over TorchBackend on a RealClock; checks answers and
             that every INFER went through the kernel (24 launches each);
             then INFER time per bucket and a torch.profiler breakdown, which
             must show 24 flash_decode device kernels per INFER (one per
             layer: a single launch per call). Then full-width
             recurrentgemma-2b the same way: 10 requests, every one ok, 8
             flash_decode launches per INFER (its local layers).
8. resnet  — full-width ResNet-50 (the paper's evaluation model; 224x224,
             256 classes, random weights from a seed) through
             make_resnet_model: the card's bf16 logits at batch 2 against
             the port's CPU path, then per bucket INFER time on the host
             clock and on CUDA events, a torch.profiler breakdown, the
             bound, LOAD time and peak device bytes; then the paper's Fig. 2
             on the card: the spread of 500 back-to-back INFERs at batch 1
             and 200 at batch 16, on the host clock, on CUDA events around
             the eager forward, and on CUDA events around replays of the
             forward captured in a CUDA graph (device time alone).
9. profile — the offline profiler (repro_torch.telemetry.profiler
             build_store) over full-width ResNet-50, full-width qwen2-0.5b
             decode (qwen2_full_decode) and the profiler's default_specs();
             the store is saved, reloaded, checked for every key and printed
             as Table 1.
10. runtime — the copied distributed runtime on the card: one Worker over
             TorchBackend serving both full-width models, seeded from the
             profile phase's store, behind a WorkerHost that talks to a
             ControllerServer over a LoopbackLink (every frame encoded and
             decoded); a RemoteClient on a second link sends an open-loop
             workload (Poisson, 25 requests/s per model for 1.8 s, SLO 5 s)
             on a RealClock. Checks at least 90% ok, zero warmup
             re-measurement, 24 flash_decode launches per qwen2 INFER, and
             that update_store folds only the run's own samples.

Every torch.profiler reading is taken from the most complete of three
profiled sessions (the profiler now and then drops a buffer of device
records). Then the {"kernels": [...]} summary, the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}. Any failure exits nonzero
before that, with its reason on stdout (a JSON line) and on stderr.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
    # the fourth slice's heads, small: recurrentgemma's (G=10, D=256) ring
    # past its window, a cross cache with every slot live, qwen3-moe's G=16
    (1, 64, 10, 1, 256, 64, True, 0.0, 100),
    (2, 48, 16, 16, 64, 0, False, 0.0, 47),
    (1, 64, 16, 1, 128, 0, False, 0.0, 50),
]
# flash_decode at the new paths' first decode step, bf16 (B, S, H, K, D,
# window, ring, cap, cur): recurrentgemma's 2048-slot ring after the
# (1, 3072) prompt, seamless's cross cache over 2048 frames, qwen3-moe
# after (1, 2048), llava after its 4096-row prompt; each also timed
DECODE_PATH = [
    (1, 2048, 10, 1, 256, 2048, True, 0.0, 3072),
    (1, 2048, 16, 16, 64, 0, False, 0.0, 2047),
    (1, 2064, 64, 4, 128, 0, False, 0.0, 2048),
    (1, 4112, 32, 8, 128, 0, False, 0.0, 4096),
]
# qwen2-0.5b at the published widths: K=2 kv-heads, G=7, D=64, bf16. ctx 128
# with cur 64 is what the serving engine runs, at each of its batch buckets;
# 4096 is a long full cache; (1, 2064, 2048) is the first decode step after
# the prefill path's (1, 2048) prompt (cache_len 2048 + N_DECODE).
CTX, CUR = 128, 64
BUCKETS = (1, 2, 4, 8)
SERVE_SHAPES = ([(b, CTX, CUR) for b in BUCKETS]
                + [(1, 4096, 4095), (8, 4096, 4095), (1, 2064, 2048)])
# traffic as tests/test_system.py::test_real_jax_serving_roundtrip: one
# request every 20 ms, SLO 5 s
N_REQUESTS, GAP_S, SLO_S = 30, 0.02, 5.0
# INFERs per bucket in the dedicated sweep: enough for a p99 to be more than
# the maximum
SWEEP_REPS = 200

# tests/test_kernels.py::ATTN_CASES (B, Sq, Skv, H, K, D, causal, window,
# cap); then a gemma2-style local layer at its full heads (32 over 16 kv
# heads, D=128) with a window shorter than S and softcap 50; then the
# largest head, D=256 (160 KB of shared memory in bf16); then D=80, which
# the bf16 kernel runs on its D=128 panels with zero-filled columns
ATTN_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0, 0.0),
    (1, 100, 100, 2, 2, 16, True, 24, 50.0),
    (2, 48, 48, 4, 1, 64, False, 0, 0.0),
    (1, 96, 96, 8, 8, 128, True, 0, 30.0),
    (1, 33, 33, 2, 1, 16, True, 7, 0.0),
    (1, 512, 512, 32, 16, 128, True, 128, 50.0),
    (1, 130, 130, 4, 2, 256, True, 0, 0.0),
    (1, 96, 96, 4, 2, 80, True, 0, 0.0),
    # the fourth slice's heads, small: G=10 at D=256 with a window shorter
    # than S, cross (non-causal, Sq != Skv both ways), G=16 at D=128
    (1, 200, 200, 10, 1, 256, True, 64, 0.0),
    (2, 100, 180, 16, 16, 64, False, 0, 0.0),
    (1, 180, 100, 16, 16, 64, False, 0, 0.0),
    (1, 160, 160, 64, 4, 128, True, 0, 0.0),
]
# flash_attention at the prefill paths' shapes, bf16 (B, Sq, Skv, H, K, D,
# causal, window), each checked against the plain version and timed:
# qwen2-0.5b (H=14, K=2, D=64) at (1, 2048) and (4, 512), phi4-mini's D=128
# heads (H=24, K=8; timed only before this slice), recurrentgemma's local
# layer (window 2048) at (1, 2048) and past the window at (1, 3072),
# seamless's encoder (non-causal) and cross layer (1024 tokens over 2048
# frames), qwen3-moe (G=16) and llava at (1, 4096)
ATTN_TIMED = [
    (1, 2048, 2048, 14, 2, 64, True, 0),
    (4, 512, 512, 14, 2, 64, True, 0),
    (1, 2048, 2048, 24, 8, 128, True, 0),
    (1, 2048, 2048, 10, 1, 256, True, 2048),
    (1, 3072, 3072, 10, 1, 256, True, 2048),
    (1, 2048, 2048, 16, 16, 64, False, 0),
    (1, 1024, 2048, 16, 16, 64, False, 0),
    (1, 2048, 2048, 64, 4, 128, True, 0),
    (1, 4096, 4096, 32, 8, 128, True, 0),
]
# the attention backward (csrc/flash_attention_bwd.cu) against
# flash_attention_bwd_plain from the same out, lse and dout: ATTN_CASES in
# f32 and bf16 (window + softcap, D=256, Sq != Skv both ways, G=10 and 16),
# then bf16 at the train path's shapes with qwen2-0.5b's heads (B, S),
# the train phase's own call (4, 256) (8 rows in 2 microbatches) among
# them, and at every timed shape; dq, dk and dv each within BWD_TOL of its
# largest element (in bf16 the kernel sums p and ds products in another
# order than the plain einsums, both from the same bf16-rounded p and ds).
# Timed at BWD_TIMED (B, S, H, K, D, all causal): qwen2-0.5b at (1, 2048),
# (4, 512) and (4, 256), then phi4-mini's D=128 heads; the eager kernel and
# SDPA's backward in BWD_ROUNDS interleaved turns of BWD_ROUND_CALLS calls.
# BWD_REPEAT: bf16 cases whose repeated calls must be bit-equal (the train
# loop's restart check): qwen2 at (1, 2048), and G=16 with a window.
BWD_PATH = [(8, 256), (4, 256), (1, 2048), (4, 512), (2, 2048)]
BWD_TIMED = [(1, 2048, 14, 2, 64), (4, 512, 14, 2, 64), (4, 256, 14, 2, 64),
             (1, 2048, 24, 8, 128)]
BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
BWD_ROUNDS, BWD_ROUND_CALLS = 7, 50
BWD_REPEAT = [(1, 2048, 2048, 14, 2, 64, True, 0, 0.0),
              (1, 512, 512, 64, 4, 128, True, 128, 0.0)]
# tests/test_kernels.py::SSD_CASES (B, L, H, P, N, chunk); L=50 is ragged
SSD_CASES = [(2, 64, 3, 16, 8, 16), (1, 50, 2, 8, 16, 16),
             (1, 128, 4, 32, 16, 32)]
# the reference's SSD tolerance. Against the plain version in bf16: both
# round x*dt and the decay-weighted scores to bf16; the plain version also
# rounds the scores C.B^T and the intra-chunk product to bf16 (its bf16
# einsums), which the kernel keeps in f32; the kernel rounds the chunk-state
# operand x*dt*to_end to bf16 (the plain version takes that product in f32)
# and carries S_in into the inter-chunk product as two bf16 parts.
SSD_TOL = {"float32": 3e-4, "bfloat16": 4e-2}
# the SSD backward (ssd_scan_bwd), held to ssd_scan_bwd_plain within SSD_TOL
# of each gradient's largest element, with and without a final-state
# cotangent: the CPU tests' cases (SSD_CASES, then four chunks with a ragged
# tail over an odd head count), then at mamba2-130m's widths the train
# path's microbatch (4, 1024), the long steps' (1, 2048) and a ragged L
# over an odd head count; timed at the train path's two shapes
SSD_BWD_CASES = SSD_CASES + [(2, 100, 5, 16, 16, 32)]
SSD_BWD_PATH = [(4, 1024, 24, 64, 128, 256), (1, 2048, 24, 64, 128, 256),
                (1, 700, 23, 64, 128, 256)]
SSD_BWD_TIMED = [(4, 1024), (1, 2048)]
# the SSD backward's tensor-core kernels, whose registers and spills the
# kernels line prints
SSD_BWD_KERNELS = ("ssd_bwd_chunk_states_bf16", "ssd_bwd_keys_bf16",
                   "ssd_bwd_queries_bf16")
# the prefill paths, each shape followed by N_DECODE greedy decode steps:
# arch -> (B, S) of the reference's configs/shapes.py::prefill_inputs rule
# (S the prompt; seamless: S frames and min(1024, S) tokens; llava: S rows
# in all, img_tokens of them image rows), timed PREFILL_REPS times each.
# qwen2-0.5b (bf16, H=14, K=2, D=64, causal) and mamba2-130m (bf16, H=24,
# P=64, N=128, chunk 256) draw their weights on the host, the others on the
# card. qwen3-moe runs at full width with its depth cut to MOE_LAYERS of 94
# (one layer's 128 experts are 4.8 GB in bf16).
PREFILL_SHAPES = [(1, 2048), (4, 512)]
PREFILL_PATHS = {
    "qwen2-0.5b": PREFILL_SHAPES,
    "mamba2-130m": PREFILL_SHAPES,
    "recurrentgemma-2b": PREFILL_SHAPES + [(1, 3072)],
    "qwen3-moe-235b-a22b": PREFILL_SHAPES,
    "seamless-m4t-medium": PREFILL_SHAPES,
    "llava-next-mistral-7b": [(1, 4096), (2, 3072)],
}
HOST_DRAWN = ("qwen2-0.5b", "mamba2-130m")
MOE_LAYERS = 4
# the full-width identity (prefill vs train, decode vs train) is held for the
# decoder-only paths; the reference holds none for enc-dec or VLM input
IDENTITY_ARCHS = ("qwen2-0.5b", "mamba2-130m", "recurrentgemma-2b",
                  "qwen3-moe-235b-a22b")
# card vs CPU at smoke size: every prefill path, and llama4-maverick (one
# full-width layer is 32 GB: its shared expert runs here only)
SMOKE_ARCHS = tuple(PREFILL_PATHS) + ("llama4-maverick-400b-a17b",)
N_DECODE = 16
PREFILL_REPS = {"qwen2-0.5b": 5, "mamba2-130m": 5}     # 3 for the others
# the RG-LRU hybrid served as qwen2-0.5b is: requests and sweep INFERs
RG_ARCH, RG_REQUESTS, RG_SWEEP = "recurrentgemma-2b", 10, 20
# ResNet-50 at full width: the engine's buckets, INFERs per bucket for the
# per-bucket times, and the paper's Fig. 2 runs (batch, back-to-back INFERs)
RESNET_BUCKETS = (1, 2, 4, 8, 16)
RESNET_IMG = 224
RESNET_REPS = 30
FIG2_RUNS = ((1, 500), (16, 200))
# the profile phase's timed repetitions per bucket (the profiler's default)
PROFILE_REPS = 3
# the train phase: full-width qwen2-0.5b, then mamba2-130m (AdamW, 2
# microbatches, remat) through repro_torch.launch.train.train at
# TRAIN_PATHS[arch] = (B, S) for TRAIN_STEPS steps with a checkpoint every
# TRAIN_CKPT_EVERY, then resumed from the first checkpoint; TRAIN_TIMED
# steps timed from that checkpoint, and TRAIN_LONG_STEPS at (B, S) =
# TRAIN_LONG (one 2048-token sequence per microbatch). mamba2's (8, 1024)
# gives 4 chunks of 256 a sequence (at S = 256 the chunk is the sequence
# and every inter-chunk term of the SSD backward is zero). Each path's
# smoke-size train step on the card against the CPU: TRAIN_SMOKE[arch]
TRAIN_PATHS = {"qwen2-0.5b": (8, 256), "mamba2-130m": (8, 1024)}
TRAIN_SMOKE = {"qwen2-0.5b": "gemma2-27b", "mamba2-130m": "mamba2-130m"}
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 4
TRAIN_TIMED = 5
TRAIN_LONG, TRAIN_LONG_STEPS = (2, 2048), 2
# the segment-parallel context attention's kernel changes (models/flash_xla.py,
# the reference's flash_xla._make_seg_flash): flash_attention with a key
# offset k0 per segment, against its plain version on the rows that see a
# key of the segment, in f32 and bf16, over ATTN_CASES and SEG_PATH
# (B, S, H, K, D, window, all causal: qwen2-0.5b at (1, 2048),
# recurrentgemma's windowed layer at (1, 3072)), each cut into SEG_SPLITS
# segments (16 is the production model axis) where they divide S; the
# segments merged by lse against the unsegmented kernel and the plain
# version; the backward per segment from the merged out and lse (each
# segment's dk, dv against the slice of the unsegmented backward's, the sum
# of the segments' dq against its dq) at SEG_BWD (qwen2-0.5b's heads, the
# train call (4, 256) and (1, 2048)); flash_decode with the rows' lse, the
# cache cut into SEG_SPLITS shards and merged against the unsplit kernel,
# at SEG_DECODE (B, S, cur: the qwen2 served cache at buckets 1 and 8,
# S = 4096). Timed: the SEG_TIMED_SPLIT segment calls beside the whole
# call at (1, 2048), forward and backward, the last segment (the most live
# pairs) alone beside its plain version and SDPA with its mask, and one
# decode shard with and without lse
SEG_SPLITS = (2, 16)
SEG_PATH = [(1, 2048, 14, 2, 64, 0), (1, 3072, 10, 1, 256, 2048)]
SEG_BWD = [(4, 256), (1, 2048)]
SEG_DECODE = [(1, 128, 64), (8, 128, 64), (1, 4096, 4095)]
SEG_TIMED_SPLIT = 16
# the sharded phase's expert-parallel MoE: full-width qwen3-moe-235b-a22b cut
# to MOE_LAYERS through the (1, 1) mesh (the reference's use_ep condition
# holds on it), a prefill at each PREFILL_SHAPES and N_DECODE greedy decode
# steps; one MoE block against a masked-dense version with the same drop
# table; repeats bit for bit; a kept token's bits at MOE_ROWS tokens; the
# expert GEMMs' device time, the expert-parallel path beside the dense one
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_ROWS = (2048, 2049, 1)
# counts of 64-row blocks in one batched expert product (the production
# mesh's capacity dim holds ~80 of a 4096-token chunk), each block held bit
# for bit to a product of that block alone
MOE_BLOCKS = (1, 2, 3, 5, 8, 16, 33, 80)
# the sharded phase: the train and serve paths through build_sharded_step on
# a one-rank ("data", "model") mesh over NCCL, held to the plain steps from
# the same (conditioned) weights: SHARDED_TRAIN[arch] = ((B, S), steps
# compared), then SHARDED_TIMED more steps of each, alternating, for the
# p50s; qwen2-0.5b's prefill at SHARDED_PREFILL and N_DECODE greedy decode
# steps; the meshed launcher for SHARDED_LAUNCH_STEPS steps at the train
# path's shape, a checkpoint every SHARDED_LAUNCH_CKPT, resumed from the
# first
SHARDED_TRAIN = {"qwen2-0.5b": ((8, 256), 3), "mamba2-130m": ((8, 1024), 2)}
SHARDED_TIMED = 4
# qwen2-0.5b's sharded train step also with Adafactor (the optimizer of the
# large models, whose sharded update reduces the local shards' means):
# SHARDED_ADAFACTOR_STEPS steps, bit for bit with the plain step; every
# sharded train step's peak memory within SHARDED_PEAK_REL of the plain
# step's (on one rank nothing is gathered)
SHARDED_ADAFACTOR_STEPS, SHARDED_PEAK_REL = 1, 0.05
SHARDED_PREFILL = (1, 2048)
SHARDED_LAUNCH_STEPS, SHARDED_LAUNCH_CKPT = 4, 2
# the vocab-parallel layer's per-shard bodies (distributed/vocab.py) on one
# card: qwen2-0.5b's table and one train step's logits cut as the
# production mesh's model axis cuts them; VOCAB_TURNS timings of each
VOCAB_SHARDS, VOCAB_TOL, VOCAB_TURNS = 16, 2e-4, 3
# the runtime phase's open-loop workload: Poisson arrivals per model for
# RUNTIME_S seconds. The loop sends the next request only after the INFER
# it is blocked in (qwen2's take ~45 ms), so 25 r/s per model sends ~34/s
# in all: 1.8 s gives about 60 requests
RUNTIME_RATE, RUNTIME_S = 25.0, 1.8


def emit(obj):
    print(json.dumps(obj), flush=True)


def die(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    print(f"chip_smoke: {phase} failed: {msg}", file=sys.stderr, flush=True)
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


def _capture(fn, calls=1):
    """``calls`` calls of ``fn`` captured in one CUDA graph, after three
    warm-up calls on a side stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(fn, per_graph=20, replays=20):
    """Device ms per call: ``per_graph`` calls captured in one CUDA graph,
    replayed with CUDA events around the replays (no host work between
    launches)."""
    import torch
    graph = _capture(fn, per_graph)
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
    names = build.sources()
    with ThreadPoolExecutor(len(names)) as pool:       # one nvcc per source
        libs = dict(zip(names, pool.map(build.build, names)))
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


def _bound(bytes_moved, ops):
    """The least time the card could take: bytes at 3.35 TB/s or operations
    at the bf16 tensor-core peak, whichever is longer, and which it is."""
    from repro_torch.utils import H100
    t_bytes = bytes_moved / H100.hbm_bandwidth * 1e3
    t_ops = ops / H100.peak_bf16_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "operations": ops}


def _rated(entry):
    """Achieved TFLOP/s and GB/s of the kernel's device time, and the share
    of the bound it reaches (bound_ms / ms)."""
    ms = entry["ms"]
    return {**entry, "tflops": entry["operations"] / ms / 1e9,
            "gbps": entry["bytes"] / ms / 1e6,
            "bound_share": entry["bound_ms"] / ms}


def _timed(kernel, plain, library):
    """Device ms (CUDA-graph replay) and eager ms of each callable; library
    may be None."""
    times = {}
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        times[name + "ms"] = graph_ms(fn) if fn else None
        times[name + "eager_ms"] = cuda_ms(fn, 200) if fn else None
    return times


def _time_decode(case):
    """Kernel, plain and SDPA times of flash_decode at one bf16 case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    B, S, H, K, D, window, ring, cap, cur = case
    G = H // K
    q, k, v, kpos = _case_tensors(case, torch.bfloat16, seed=1)
    kw = dict(window=window, cap=cap)
    kernel = lambda: fd.flash_decode(q, k, v, kpos, cur, **kw)      # noqa: E731
    plain = lambda: fd.flash_decode_plain(q, k, v, kpos, cur, **kw)  # noqa: E731
    # yardstick only: one library call computing the same function (no
    # softcap in any timed case)
    qs = q[:, :, None, :]                                     # (B,H,1,D)
    ks = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vs = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    live = (kpos >= 0) & (kpos <= cur)
    if window:
        live &= kpos > cur - window
    mask = live[None, None, None, :]
    library = lambda: F.scaled_dot_product_attention(                # noqa: E731
        qs, ks, vs, attn_mask=mask)
    times = _timed(kernel, plain, library)
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)[:, :, 0]
    lib_err = (lib_out.float() - kernel().float()).abs().max().item()
    # least time for the same work: each input read once, the output written
    # once, over the keys this data needs (the live slots)
    n_keys = int(live.sum().item())
    bytes_moved = (2 * B * H * D * 2                   # q in, out
                   + 2 * B * n_keys * K * D * 2        # K and V rows
                   + S * 4)                            # kpos
    ops = 4 * B * H * n_keys * D                       # QK^T and PV
    return _rated({"B": B, "S": S, "cur": cur, "K": K, "G": G, "D": D,
                   "window": window, "ring": ring,
                   "n_split": fd.split_plan(B, K, S, fd._sm_count(q.device)),
                   "dtype": "bfloat16", **times, "library_max_abs_err": lib_err,
                   **_bound(bytes_moved, ops)})


def _allclose_err(got, want, tol):
    """(max abs error, whether |got - want| <= tol + tol*|want| everywhere:
    the reference tests' rtol = atol = tol), after checking got is finite."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = (bool(torch.isfinite(got).all().item())
          and bool((diff <= tol + tol * want.abs()).all().item()))
    return diff.max().item(), ok


def _attn_tensors(case, dtype, seed=0):
    import torch
    B, Sq, Skv, H, K, D = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))


def _check_attention(case, dtype):
    import torch
    from repro_torch.kernels import flash_attention as fa
    causal, window, cap = case[6:]
    q, k, v = _attn_tensors(case, getattr(torch, dtype))
    got = fa.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    cap=cap)
    err, ok = _allclose_err(got, want, TOL[dtype])
    if not ok:
        die("kernels", f"flash_attention {case} {dtype}: max abs err {err}, "
                       f"outside rtol = atol = {TOL[dtype]} (or non-finite)")
    return err


def _bwd_tensors(case, dtype, seed=0):
    """q, k, v of ``case`` and an output gradient dout, drawn on the card."""
    import torch
    q, k, v = _attn_tensors(case, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    return q, k, v, torch.randn(q.shape, generator=g, device="cuda").to(dtype)


def _check_attention_bwd(case, dtype):
    """The forward kernel's out and lse (the train path's), then the
    backward kernels against flash_attention_bwd_plain from the same out,
    lse and dout: (max abs error of dq, dk, dv; the largest of their errors
    relative to each one's largest element). lse is held to the plain
    version's within the f32 tolerance."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    causal, window, cap = case[6:]
    kw = dict(causal=causal, window=window, cap=cap)
    q, k, v, dout = _bwd_tensors(case, getattr(torch, dtype))
    out, lse = fa._forward(q, k, v, causal, window, cap, want_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    _, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    lse_err, lse_ok = _allclose_err(lse, want_lse, TOL["float32"])
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    abs_err, rel_err = 0.0, 0.0
    for name, a, w in zip("qkv", got, want):
        if not torch.isfinite(a).all().item():
            die("kernels", f"flash_attention_bwd {case} {dtype}: d{name} "
                           f"non-finite")
        err = (a.float() - w.float()).abs().max().item()
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(w.float().abs().max().item(), 1e-30))
    if not (lse_ok and rel_err <= BWD_TOL[dtype]):
        die("kernels", f"flash_attention_bwd {case} {dtype}: lse err "
                       f"{lse_err} (tol {TOL['float32']}), grads {rel_err} "
                       f"of the largest element > {BWD_TOL[dtype]}")
    return abs_err, rel_err


def _time_attention_bwd(B, S, H, K, D):
    """Backward kernel, plain and SDPA-backward times at one causal bf16
    train shape (B, S) with H query heads over K kv heads of width D; the
    forward's time with lse written and without, in turns (off, on, on,
    off)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout = _bwd_tensors((B, S, S, H, K, D), torch.bfloat16, seed=1)
    out, lse = fa._forward(q, k, v, True, 0, 0.0, want_lse=True)
    kw = dict(causal=True)
    # yardstick only: the backward of one library call computing the same
    # function, under autograd (the forward outside the timed call). The
    # autograd engine runs it on the forward's stream, which a CUDA graph
    # cannot capture, so its time is CUDA events around back-to-back eager
    # calls (the kernel's eager time beside it)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    dt = dout.transpose(1, 2)
    library = lambda: torch.autograd.grad(                    # noqa: E731
        lib_out, (qt, kt, vt), dt, retain_graph=True)
    kernel = lambda: fa.flash_attention_bwd(q, k, v, out, lse,  # noqa: E731
                                            dout, **kw)
    times = _timed(kernel,
                   lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse,
                                                        dout, **kw),
                   None)
    # the eager kernel and the eager library in turns, one reading each a
    # round: both drift with the host, so they are compared round by round
    rounds = {"eager_ms_rounds": [], "library_ms_rounds": []}
    for _ in range(BWD_ROUNDS):
        rounds["eager_ms_rounds"].append(cuda_ms(kernel, BWD_ROUND_CALLS))
        rounds["library_ms_rounds"].append(cuda_ms(library, BWD_ROUND_CALLS))
    times["eager_ms"] = statistics.median(rounds["eager_ms_rounds"])
    times["library_ms"] = times["library_eager_ms"] = statistics.median(
        rounds["library_ms_rounds"])
    rounds["rounds_kernel_faster"] = sum(
        a < b for a, b in zip(rounds["eager_ms_rounds"],
                              rounds["library_ms_rounds"]))
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    lib = library()
    lib_err = max((a.float() - b.transpose(1, 2).float()).abs().max().item()
                  for a, b in zip(got, lib))
    fwd = [graph_ms(lambda: fa._forward(q, k, v, True, 0, 0.0, want_lse=w))
           for w in (False, True, True, False)]
    pairs = B * H * S * (S + 1) // 2         # live (q, k) pairs, causal
    bytes_moved = (4 * B * S * H * D * 2     # q, out, dout in; dq out
                   + 4 * B * S * K * D * 2   # k, v in; dk, dv out
                   + B * H * S * 4)          # lse
    ops = 10 * D * pairs                     # scores, dout.v^T, dv, dk, dq
    return _rated({"B": B, "S": S, "H": H, "K": K, "D": D, "causal": True,
                   "dtype": "bfloat16", **times, **rounds,
                   "library_max_abs_err": lib_err,
                   "library_note": "backward of F.scaled_dot_product_attention"
                                   "(enable_gqa=True) under autograd; CUDA "
                                   "events around eager calls; median of "
                                   "rounds interleaved with the kernel's",
                   "forward_ms_lse_off": (fwd[0] + fwd[3]) / 2,
                   "forward_ms_lse_on": (fwd[1] + fwd[2]) / 2,
                   "forward_ms_turns": fwd,
                   **_bound(bytes_moved, ops)})


def _ssd_tensors(case, dtype, seed=0):
    """The reference tests' draws: x, b, c ~ N(0, 0.25), dt ~ U(0.01, 0.2),
    a ~ -U(0.5, 2)."""
    import torch
    B, L, H, P, N = case[:5]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    x = (torch.randn((B, L, H, P), generator=g, device=dev) * 0.5).to(dtype)
    dt = torch.rand((B, L, H), generator=g, device=dev) * 0.19 + 0.01
    a = -(torch.rand((H,), generator=g, device=dev) * 1.5 + 0.5)
    b = (torch.randn((B, L, N), generator=g, device=dev) * 0.5).to(dtype)
    c = (torch.randn((B, L, N), generator=g, device=dev) * 0.5).to(dtype)
    return x, dt, a, b, c


def _check_ssd(case, dtype):
    """(max abs error of y, of the state) against the plain version."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    args = _ssd_tensors(case, getattr(torch, dtype))
    y, state = ss.ssd_scan(*args, chunk=case[5])
    torch.cuda.synchronize()
    want_y, want_s = ss.ssd_scan_plain(*args, chunk=case[5])
    tol = SSD_TOL[dtype]
    err_y, ok_y = _allclose_err(y, want_y, tol)
    err_s, ok_s = _allclose_err(state, want_s, tol)
    if not (ok_y and ok_s):
        die("kernels", f"ssd_scan {case} {dtype}: "
                       f"max abs err y {err_y}, state {err_s}, outside "
                       f"rtol = atol = {tol}")
    return err_y, err_s


def _attn_mask(Sq, Skv, causal, window):
    """(Sq, Skv) bool: the pairs flash_attention keeps (positions from 0)."""
    import torch
    qpos = torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Skv, device="cuda")[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


def _time_attention(B, Sq, Skv, H, K, D, causal, window):
    """Kernel, plain and SDPA times of flash_attention at one bf16 shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_tensors((B, Sq, Skv, H, K, D), torch.bfloat16, seed=1)
    kw = dict(causal=causal, window=window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (B, heads, S, D)
    mask = _attn_mask(Sq, Skv, causal, window)
    pairs = int(mask.sum().item())           # (q, k) pairs under the mask
    # yardstick only: one library call computing the same function; a mask
    # only where is_causal (or none) does not say it
    plain_causal = causal and Sq == Skv and (not window or window >= Sq)
    lib_kw = (dict(is_causal=causal) if plain_causal or not (causal or window)
              else dict(attn_mask=mask))
    library = lambda: F.scaled_dot_product_attention(        # noqa: E731
        qt, kt, vt, enable_gqa=True, **lib_kw)
    times = _timed(lambda: fa.flash_attention(q, k, v, **kw),
                   lambda: fa.flash_attention_plain(q, k, v, **kw), library)
    lib_err = (library().transpose(1, 2).float()
               - fa.flash_attention(q, k, v, **kw).float()).abs().max().item()
    bytes_moved = 2 * (B * Sq * H * D) * 2 + 2 * (B * Skv * K * D) * 2
    ops = 4 * B * H * D * pairs              # QK^T and PV
    return _rated({"B": B, "S": Sq, "Skv": Skv, "H": H, "K": K, "D": D,
                   "causal": causal, "window": window, "dtype": "bfloat16",
                   **times, "library_max_abs_err": lib_err,
                   **_bound(bytes_moved, ops)})


def _kernel_passes(call, calls=10, keys=None):
    """The device kernels of ``calls`` calls of ``call()`` under
    torch.profiler: kernels per call and each launch's name and device ms
    per call. ``keys``, a list, gets the kernels' full names."""
    import torch
    call()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            call()
        torch.cuda.synchronize()

    dev, _, sessions = _device_events(run)
    if keys is not None:
        keys += [e.key for e in dev]
    return {"device_kernels_per_call": sum(e.count for e in dev) / calls,
            "profile_sessions_kernels": sessions,
            "passes": [{"name": e.key[:60], "count": e.count,
                        "ms_per_call": getattr(e, "self_device_time_total", 0)
                        / 1e3 / calls} for e in dev]}


def _ssd_passes(args, Q):
    """ssd_scan's passes (_kernel_passes) and the head group in use (the
    last template argument of ssd_chunk_output_bf16)."""
    from repro_torch.kernels import ssd_scan as ss
    keys = []
    res = _kernel_passes(lambda: ss.ssd_scan(*args, chunk=Q), keys=keys)
    hg = [int(m.group(1)) for k in keys for m in
          [re.search(r"ssd_chunk_output_bf16<\d+, \d+, (\d+)>", k)] if m]
    return {"head_group": hg[0] if len(hg) == 1 else
            f"not measured: {len(hg)} output kernels in the profile", **res}


def _time_ssd(B, L):
    """Kernel and plain times at one mamba2-130m prefill shape, and the
    device time of each pass. No single PyTorch call computes the SSD scan,
    so there is no library time."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    H, P, N, Q = 24, 64, 128, 256
    args = _ssd_tensors((B, L, H, P, N), torch.bfloat16, seed=1)
    times = _timed(lambda: ss.ssd_scan(*args, chunk=Q),
                   lambda: ss.ssd_scan_plain(*args, chunk=Q), None)
    from repro_torch.kernels import work
    ops = work.ssd_flops(B, L, H, P, N, Q)     # the scan's least operations
    bytes_moved = (2 * (B * L * H * P) * 2             # x in, y out
                   + B * L * H * 4 + H * 4             # dt, a
                   + 2 * (B * L * N) * 2               # b, c
                   + B * H * P * N * 4)                # final state
    return _rated({"B": B, "L": L, "H": H, "P": P, "N": N, "chunk": Q,
                   "dtype": "bfloat16", **times,
                   "library_note": "no single PyTorch call computes the SSD scan",
                   **_ssd_passes(args, Q),
                   **_bound(bytes_moved, ops)})


def _ssd_bwd_tensors(case, dtype, seed=0):
    """The forward's inputs of ``case`` and the cotangents dy and dS, drawn
    on the card."""
    import torch
    B, L, H, P, N = case[:5]
    args = _ssd_tensors(case, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    dy = torch.randn((B, L, H, P), generator=g, device="cuda").to(dtype)
    ds = torch.randn((B, H, P, N), generator=g, device="cuda")
    return args, dy, ds


def _check_ssd_bwd(case, dtype, with_state):
    """ssd_scan_bwd against ssd_scan_bwd_plain on the same inputs: (max abs
    error of dx, ddt, da, db, dc; the largest of their errors relative to
    each one's largest element), or the run dies."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    args, dy, ds = _ssd_bwd_tensors(case, getattr(torch, dtype))
    ds = ds if with_state else None
    got = ss.ssd_scan_bwd(*args, dy, ds, chunk=case[5])
    torch.cuda.synchronize()
    want = ss.ssd_scan_bwd_plain(*args, dy, ds, chunk=case[5])
    abs_err, rel_err = 0.0, 0.0
    for name, a, w in zip(("x", "dt", "a", "b", "c"), got, want):
        if a.shape != w.shape or not torch.isfinite(a).all().item():
            die("kernels", f"ssd_scan_bwd {case} {dtype}: d{name} "
                           f"{tuple(a.shape)} non-finite or misshapen")
        err = (a.float() - w.float()).abs().max().item()
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(w.float().abs().max().item(), 1e-30))
    if not rel_err <= SSD_TOL[dtype]:
        die("kernels", f"ssd_scan_bwd {case} {dtype} dS={with_state}: "
                       f"{rel_err} of the largest element > {SSD_TOL[dtype]}")
    return abs_err, rel_err


def _check_ssd_bwd_repeat(case):
    """Two bf16 backward calls on the same inputs: every gradient bit for
    bit, or the run dies."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    args, dy, ds = _ssd_bwd_tensors(case, torch.bfloat16, seed=2)
    first = ss.ssd_scan_bwd(*args, dy, ds, chunk=case[5])
    again = ss.ssd_scan_bwd(*args, dy, ds, chunk=case[5])
    torch.cuda.synchronize()
    for name, a, b in zip(("x", "dt", "a", "b", "c"), first, again):
        if not torch.equal(a, b):
            die("kernels", f"ssd_scan_bwd {case}: d{name} differs between "
                           f"two calls on the same inputs")
    return list(case)


def _ssd_bwd_ops(B, L, H, P, N, Q):
    """The least operations of the SSD backward (``kernels/work.py``)."""
    from repro_torch.kernels import work
    return work.ssd_flops(B, L, H, P, N, Q, backward=True)


def _time_ssd_bwd(B, L):
    """Backward kernel and plain times at one mamba2-130m train shape (no
    final-state cotangent: the train path drops the state), and the device
    time of each of its launches. No single PyTorch call computes the SSD
    scan's backward, so there is no library time."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    H, P, N, Q = 24, 64, 128, 256
    args, dy, _ = _ssd_bwd_tensors((B, L, H, P, N), torch.bfloat16, seed=1)
    times = _timed(lambda: ss.ssd_scan_bwd(*args, dy, chunk=Q),
                   lambda: ss.ssd_scan_bwd_plain(*args, dy, chunk=Q), None)
    bytes_moved = (3 * (B * L * H * P) * 2             # x, dy in; dx out
                   + 2 * B * L * H * 4 + 2 * H * 4     # dt, ddt; a, da
                   + 4 * (B * L * N) * 2)              # b, c in; db, dc out
    return _rated({"B": B, "L": L, "H": H, "P": P, "N": N, "chunk": Q,
                   "dtype": "bfloat16", **times,
                   "library_note": "no single PyTorch call computes the SSD "
                                   "scan's backward",
                   **_kernel_passes(lambda: ss.ssd_scan_bwd(*args, dy,
                                                            chunk=Q)),
                   **_bound(bytes_moved, _ssd_bwd_ops(B, L, H, P, N, Q))})


def _mma_counts(name):
    """(HGMMA, HMMA): wgmma and mma.sync instructions in the SASS of the
    built library ``name``, from cuobjdump; a note for each where the tool
    is missing or fails."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        note = "cuobjdump not found: not measured"
        return note, note
    sass = subprocess.run([tool, "-sass", str(build.build(name))],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        note = f"cuobjdump failed: {sass.stderr.strip()[:200]}"
        return note, note
    return tuple(sum(len(re.findall(rf"\b{op}\b", line))
                     for line in sass.stdout.splitlines())
                 for op in ("HGMMA", "HMMA"))


def _check_bwd_repeat(case):
    """Two bf16 backward calls on the same inputs: dq, dk and dv bit for
    bit, or the run dies."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    causal, window, cap = case[6:]
    q, k, v, dout = _bwd_tensors(case, torch.bfloat16, seed=2)
    out, lse = fa._forward(q, k, v, causal, window, cap, want_lse=True)
    kw = dict(causal=causal, window=window, cap=cap)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, again):
        if not torch.equal(a, b):
            die("kernels", f"flash_attention_bwd {case}: d{name} differs "
                           f"between two calls on the same inputs")
    return list(case)


def _live_rows(Sq, Skv, causal, window, k0):
    """(Sq,) bool: the query rows that see a key of a segment from k0."""
    from repro_torch.kernels import flash_attention as fa
    return fa._mask(Sq, Skv, causal, window, "cuda", k0).any(dim=1)


def _check_segments(case, dtype):
    """flash_attention cut into SEG_SPLITS segments along the keys (those
    that divide Skv): each segment's kernel call with its k0 against the
    plain version on its live rows (out within TOL, lse within the f32
    tolerance), then the segments merged by lse against the unsegmented
    kernel and the plain version. Returns (largest segment error, largest
    merge error)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, Sq, Skv, H, K, D, causal, window, cap = case
    kw = dict(causal=causal, window=window, cap=cap)
    q, k, v = _attn_tensors(case, getattr(torch, dtype), seed=3)
    whole, _ = fa._forward(q, k, v, causal, window, cap, True)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    seg_err, merge_err = 0.0, 0.0
    for n in SEG_SPLITS:
        if Skv % n:
            continue
        c = Skv // n
        outs, lses = [], []
        for a in range(0, Skv, c):
            ks, vs = k[:, a:a + c], v[:, a:a + c]
            out, lse = fa._forward(q, ks, vs, causal, window, cap, True, k0=a)
            want, want_lse = fa.flash_attention_plain(
                q, ks, vs, return_lse=True, k0=a, **kw)
            live = _live_rows(Sq, c, causal, window, a)
            err, ok = _allclose_err(out[:, live], want[:, live], TOL[dtype])
            lerr, lok = _allclose_err(lse[..., live], want_lse[..., live],
                                      TOL["float32"])
            if not (ok and lok and torch.isfinite(out).all().item()):
                die("kernels", f"flash_attention k0={a} of {case} {dtype}: "
                               f"out err {err}, lse err {lerr}")
            seg_err = max(seg_err, err)
            outs.append(out)
            lses.append(lse)
        merged, _ = ops.merge(outs, lses)
        for name, ref in (("unsegmented kernel", whole), ("plain", plain)):
            err, ok = _allclose_err(merged.to(q.dtype), ref, TOL[dtype])
            if not ok:
                die("kernels", f"flash_attention {case} {dtype}: {n} "
                               f"segments merged against the {name}: max "
                               f"abs err {err}")
            merge_err = max(merge_err, err)
    return seg_err, merge_err


def _rel(a, b):
    """max |a - b| over max |b|, f32."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


def _check_segment_bwd(B, S, n):
    """bf16, qwen2-0.5b's heads, causal: each segment's backward kernel
    (k0, from the merged out and lse of the n segments) against the
    unsegmented backward: dk and dv against its slices, the f32 sum of the
    segments' dq against its dq, each within BWD_TOL of the largest
    element; each segment also against the plain backward. Returns the
    largest of those relative errors."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import flash_xla
    q, k, v, dout = _bwd_tensors((B, S, S, 14, 2, 64), torch.bfloat16, seed=4)
    out, lse = fa._forward(q, k, v, True, 0, 0.0, want_lse=True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    merged, lse_tot = flash_xla._forward(q, k, v, True, 0, 0.0, n, None)
    c, dq_sum, worst = S // n, None, 0.0
    for a in range(0, S, c):
        args = (q, k[:, a:a + c], v[:, a:a + c], merged, lse_tot, dout)
        got = fa.flash_attention_bwd(*args, k0=a)
        want = fa.flash_attention_bwd_plain(*args, k0=a)
        errs = [_rel(got[1], dk[:, a:a + c]), _rel(got[2], dv[:, a:a + c])]
        errs += [_rel(x, y) for x, y in zip(got, want)]
        if not all(torch.isfinite(x).all().item() for x in got) or max(
                errs) > BWD_TOL["bfloat16"]:
            die("kernels", f"flash_attention_bwd k0={a} of (B, S)=({B}, "
                           f"{S}) in {n} segments: rel errs {errs}")
        worst = max(worst, *errs)
        dq_sum = got[0].float() if dq_sum is None else dq_sum + got[0].float()
    err = _rel(dq_sum, dq)
    if err > BWD_TOL["bfloat16"]:
        die("kernels", f"flash_attention_bwd (B, S)=({B}, {S}): the sum of "
                       f"{n} segments' dq, rel err {err}")
    return max(worst, err)


def _check_decode_split(B, S, cur, n):
    """flash_decode with the rows' lse (bf16, qwen2-0.5b's heads): the
    output equal to the call without lse, the lse against the plain
    version's, and the cache cut into n shards, merged, against the unsplit
    kernel. Returns (lse error, merge error)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    q, k, v, kpos = _case_tensors((B, S, 14, 2, 64, 0, False, 0.0, cur),
                                  torch.bfloat16, seed=5)
    whole = fd.flash_decode(q, k, v, kpos, cur)
    out, lse = fd.flash_decode(q, k, v, kpos, cur, return_lse=True)
    _, want_lse = fd.flash_decode_plain(q, k, v, kpos, cur, return_lse=True)
    lerr, lok = _allclose_err(lse, want_lse, TOL["float32"])
    c = S // n
    parts = [fd.flash_decode(q, k[:, a:a + c], v[:, a:a + c], kpos[a:a + c],
                             cur, return_lse=True) for a in range(0, S, c)]
    merged, _ = ops.merge([o for o, _ in parts], [l for _, l in parts])
    err, ok = _allclose_err(merged.to(q.dtype), whole, TOL["bfloat16"])
    if not (torch.equal(out, whole) and lok and ok):
        die("kernels", f"flash_decode lse (B, S, cur)=({B}, {S}, {cur}) in "
                       f"{n} shards: out with lse equal "
                       f"{torch.equal(out, whole)}, lse err {lerr}, merged "
                       f"err {err}")
    return lerr, err


def _segment_mask_sdpa(q, k, v, k0, causal, window):
    """SDPA over one key segment, its mask given (yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    mask = fa._mask(q.shape[1], k.shape[1], causal, window, "cuda", k0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(           # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _time_segments(B, S, H, K, D, window, n):
    """bf16, causal: the n segment calls (k0 = 0, S/n, ...; lse written, as
    the segment path runs them) beside the whole call with lse, then the
    last segment alone (the most live pairs): kernel, plain version and
    SDPA with its mask, and its bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _attn_tensors((B, S, S, H, K, D), torch.bfloat16, seed=1)
    c = S // n

    def segments():
        for a in range(0, S, c):
            fa._forward(q, k[:, a:a + c], v[:, a:a + c], True, window, 0.0,
                        True, k0=a)
    a = S - c
    ks, vs = k[:, a:a + c], v[:, a:a + c]
    times = _timed(
        lambda: fa._forward(q, ks, vs, True, window, 0.0, True, k0=a),
        lambda: fa.flash_attention_plain(q, ks, vs, causal=True,
                                         window=window, return_lse=True, k0=a),
        _segment_mask_sdpa(q, ks, vs, a, True, window))
    pairs = int(fa._mask(S, c, True, window, "cuda", a).sum().item())
    # q read on the live rows only; out and lse written on every row (0
    # and the sentinel on the dead ones); the segment's K and V read
    live = int(_live_rows(S, c, True, window, a).sum().item())
    bytes_moved = (B * live * H * D * 2 + B * S * H * D * 2 + B * H * S * 4
                   + 2 * B * c * K * D * 2)
    return _rated({
        "B": B, "S": S, "H": H, "K": K, "D": D, "window": window,
        "segments": n, "k0": a, "live_rows": live, "dtype": "bfloat16",
        **times,
        "library_note": "F.scaled_dot_product_attention(enable_gqa=True) "
                        "with the segment's mask, no lse",
        "all_segments_ms": graph_ms(segments, per_graph=4),
        "whole_call_ms": graph_ms(lambda: fa._forward(
            q, k, v, True, window, 0.0, True)),
        **_bound(bytes_moved, 4 * B * H * D * pairs)})


def _time_segment_bwd(B, S, n):
    """bf16, qwen2-0.5b's heads, causal: the n segments' backward calls
    beside the whole backward, then the last segment's alone: kernel,
    plain version, SDPA's backward with its mask (autograd, eager) and its
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import flash_xla
    H, K, D = 14, 2, 64
    q, k, v, dout = _bwd_tensors((B, S, S, H, K, D), torch.bfloat16, seed=1)
    out, lse = fa._forward(q, k, v, True, 0, 0.0, want_lse=True)
    merged, lse_tot = flash_xla._forward(q, k, v, True, 0, 0.0, n, None)
    c = S // n

    def segments():
        for a in range(0, S, c):
            fa.flash_attention_bwd(q, k[:, a:a + c], v[:, a:a + c], merged,
                                   lse_tot, dout, k0=a)
    a = S - c
    args = (q, k[:, a:a + c], v[:, a:a + c], merged, lse_tot, dout)
    mask = fa._mask(S, c, True, 0, "cuda", a)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, args[1], args[2]))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True)
    dt = dout.transpose(1, 2)
    library = lambda: torch.autograd.grad(                    # noqa: E731
        lib_out, (qt, kt, vt), dt, retain_graph=True)
    times = _timed(lambda: fa.flash_attention_bwd(*args, k0=a),
                   lambda: fa.flash_attention_bwd_plain(*args, k0=a), None)
    times["library_ms"] = times["library_eager_ms"] = cuda_ms(library, 50)
    pairs = int(mask.sum().item())
    # q, out, dout and lse read on the live rows only; dq written on every
    # row (0 on the dead ones); the segment's K, V read and dK, dV written
    live = int(mask.any(dim=1).sum().item())
    bytes_moved = (3 * B * live * H * D * 2 + B * live * H * 4
                   + B * S * H * D * 2 + 4 * B * c * K * D * 2)
    return _rated({
        "B": B, "S": S, "H": H, "K": K, "D": D, "segments": n, "k0": a,
        "live_rows": live, "dtype": "bfloat16", **times,
        "library_note": "backward of F.scaled_dot_product_attention"
                        "(enable_gqa=True) with the segment's mask, under "
                        "autograd; CUDA events around eager calls",
        "all_segments_ms": graph_ms(segments, per_graph=4),
        "whole_call_ms": graph_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout)),
        **_bound(bytes_moved, 10 * D * B * H * pairs)})


def _time_decode_lse(S, n):
    """bf16, qwen2-0.5b's heads, B=1, cur at the end: one of n shards of an
    S-slot cache (the last, every slot live) with lse and without, its
    plain version with lse and SDPA over the shard; the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    cur = S - 1
    q, k, v, kpos = _case_tensors((1, S, 14, 2, 64, 0, False, 0.0, cur),
                                  torch.bfloat16, seed=6)
    c = S // n
    ks, vs, kp = k[:, S - c:], v[:, S - c:], kpos[S - c:]
    qt = q.reshape(1, 14, 1, 64)
    kt, vt = ks.transpose(1, 2), vs.transpose(1, 2)
    times = _timed(
        lambda: fd.flash_decode(q, ks, vs, kp, cur, return_lse=True),
        lambda: fd.flash_decode_plain(q, ks, vs, kp, cur, return_lse=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True))
    bytes_moved = 2 * c * 2 * 64 * 2 + 2 * 14 * 64 * 2 + 14 * 4
    return _rated({"B": 1, "S": S, "shards": n, "shard_slots": c, "cur": cur,
                   "H": 14, "K": 2, "D": 64, "dtype": "bfloat16", **times,
                   "without_lse_ms": graph_ms(
                       lambda: fd.flash_decode(q, ks, vs, kp, cur)),
                   "library_note": "F.scaled_dot_product_attention over the "
                                   "shard, no lse",
                   **_bound(bytes_moved, 4 * 14 * 64 * c)})


def _segment_checks():
    """The context attention's kernel checks and times (see SEG_SPLITS)."""
    cases = [c for c in ATTN_CASES] + [
        (B, S, S, H, K, D, True, w, 0.0) for B, S, H, K, D, w in SEG_PATH]
    fwd = [_check_segments(c, d) for c in cases
           for d in ("float32", "bfloat16")]
    bwd = [_check_segment_bwd(B, S, n) for B, S in SEG_BWD
           for n in SEG_SPLITS]
    dec = [_check_decode_split(B, S, cur, n) for B, S, cur in SEG_DECODE
           for n in SEG_SPLITS]
    return {
        "cases_checked": len(fwd) + len(bwd) + len(dec),
        "k0_max_abs_err": max(e[0] for e in fwd),
        "merged_max_abs_err": max(e[1] for e in fwd),
        "bwd_max_rel_err": max(bwd),
        "decode_lse_max_abs_err": max(e[0] for e in dec),
        "decode_merged_max_abs_err": max(e[1] for e in dec),
        "tolerance": TOL, "bwd_tolerance_of_largest_element": BWD_TOL,
        "forward": [_time_segments(*shape, SEG_TIMED_SPLIT)
                    for shape in SEG_PATH[:1]],
        "backward": [_time_segment_bwd(*SEG_BWD[1], SEG_TIMED_SPLIT)],
        "decode": [_time_decode_lse(4096, SEG_TIMED_SPLIT)]}


def phase_kernels():
    from repro_torch.kernels import build
    res = {}
    errs = []
    for case in DECODE_CASES:
        for dtype in ("float32", "bfloat16"):
            errs.append(_check_case(case, dtype))
    serve_errs = []
    for B, S, cur in SERVE_SHAPES:
        serve_errs.append(_check_case((B, S, 14, 2, 64, 0, False, 0.0, cur),
                                      "bfloat16"))
    path_errs = [_check_case(case, "bfloat16") for case in DECODE_PATH]
    shapes = [_time_decode((B, S, 14, 2, 64, 0, False, 0.0, cur))
              for B, S, cur in SERVE_SHAPES]
    res["flash_decode"] = {
        "phase": "kernels", "ok": True, "kernel": "flash_decode",
        "cases_checked": len(errs) + len(serve_errs) + len(path_errs),
        "max_abs_err_cases": max(errs), "max_abs_err_serving": max(serve_errs),
        "max_abs_err_path": max(path_errs),
        "tolerance": TOL, "shapes": shapes,
        "path_shapes": [_time_decode(case) for case in DECODE_PATH]}

    counts = {name: _mma_counts(name) for name in (
        "flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")}
    hgmma = {name: c[0] for name, c in counts.items()}
    for name, count in hgmma.items():
        if count == 0:
            die("kernels", f"{name}'s library holds no HGMMA instruction: "
                           f"its bf16 kernel does not run on the tensor cores")
    errs = [_check_attention(c, d) for c in ATTN_CASES
            for d in ("float32", "bfloat16")]
    path_errs = [_check_attention(shape + (0.0,), "bfloat16")
                 for shape in ATTN_TIMED]
    res["flash_attention"] = {
        "phase": "kernels", "ok": True, "kernel": "flash_attention",
        "cases_checked": len(errs) + len(path_errs),
        "max_abs_err_cases": max(errs), "max_abs_err_path": max(path_errs),
        "tolerance": TOL,
        "hgmma_instructions": hgmma["flash_attention"],
        "shapes": [_time_attention(*shape) for shape in ATTN_TIMED]}

    errs = [_check_attention_bwd(c, d) for c in ATTN_CASES
            for d in ("float32", "bfloat16")]
    path_errs = [_check_attention_bwd(case + (True, 0, 0.0), "bfloat16")
                 for case in [(B, S, S, 14, 2, 64) for B, S in BWD_PATH]
                 + [(B, S, S, H, K, D) for B, S, H, K, D in BWD_TIMED]]
    res["flash_attention_bwd"] = {
        "phase": "kernels", "ok": True, "kernel": "flash_attention_bwd",
        "cases_checked": len(errs) + len(path_errs),
        "max_abs_err_cases": max(e[0] for e in errs),
        "max_rel_err_cases": max(e[1] for e in errs),
        "max_abs_err_path": max(e[0] for e in path_errs),
        "max_rel_err_path": max(e[1] for e in path_errs),
        "tolerance_of_largest_element": BWD_TOL,
        "bit_equal_repeats": [_check_bwd_repeat(c) for c in BWD_REPEAT],
        "hgmma_instructions": hgmma["flash_attention_bwd"],
        "hmma_instructions": counts["flash_attention_bwd"][1],
        "shapes": [_time_attention_bwd(*shape) for shape in BWD_TIMED]}

    errs = [max(_check_ssd(c, d)) for c in SSD_CASES
            for d in ("float32", "bfloat16")]
    path_errs = [_check_ssd((B, L, 24, 64, 128, 256), "bfloat16")
                 for B, L in PREFILL_SHAPES]
    res["ssd_scan"] = {
        "phase": "kernels", "ok": True, "kernel": "ssd_scan",
        "cases_checked": len(errs) + len(path_errs),
        "max_abs_err_cases": max(errs),
        "max_abs_err_path": max(max(e) for e in path_errs),
        "state_max_abs_err_path": max(e[1] for e in path_errs),
        "tolerance": SSD_TOL,
        "hgmma_instructions": hgmma["ssd_scan"],
        # the prefill shapes, then the train step's call (4, 1024)
        "shapes": [_time_ssd(B, L) for B, L in PREFILL_SHAPES + [(4, 1024)]]}

    errs = [_check_ssd_bwd(c, d, w) for c in SSD_BWD_CASES
            for d in ("float32", "bfloat16") for w in (False, True)]
    path_errs = [_check_ssd_bwd(c, d, w) for c in SSD_BWD_PATH
                 for d in ("float32", "bfloat16") for w in (False, True)]
    res["ssd_scan_bwd"] = {
        "phase": "kernels", "ok": True, "kernel": "ssd_scan_bwd",
        "cases_checked": len(errs) + len(path_errs),
        "max_abs_err_cases": max(e[0] for e in errs),
        "max_rel_err_cases": max(e[1] for e in errs),
        "max_abs_err_path": max(e[0] for e in path_errs),
        "max_rel_err_path": max(e[1] for e in path_errs),
        "tolerance_of_largest_element": SSD_TOL,
        "bit_equal_repeats": [_check_ssd_bwd_repeat(c)
                              for c in SSD_BWD_PATH[:2]],
        "hgmma_instructions": hgmma["ssd_scan_bwd"],
        "hmma_instructions": counts["ssd_scan_bwd"][1],
        "ptxas": build.kernel_resources("ssd_scan_bwd", SSD_BWD_KERNELS),
        "shapes": [_time_ssd_bwd(B, L) for B, L in SSD_BWD_TIMED]}
    seg = _segment_checks()
    res["flash_attention"]["k0"] = seg["forward"][0]
    res["flash_attention_bwd"]["k0"] = seg["backward"][0]
    res["flash_decode"]["lse"] = seg["decode"][0]
    for r in res.values():
        emit(r)
    emit({"phase": "kernels", "ok": True, "check": "context_segments",
          **seg})
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


def _wall_s(fn):
    """Host seconds for ``fn()``, from a synchronised card to a synchronised
    card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device_events(run, tries=3):
    """``run()`` under torch.profiler ``tries`` times: the device kernels'
    key averages and ``run()``'s result from the session that recorded the
    most device kernels, and each session's count. The profiler now and
    then drops device records, from one to most of a session's, so one
    session can undercount; the run launches the same kernels every time,
    and the session with the most is the complete one. The device copies of
    ``record_function`` ranges (the engine's ``clockwork.*``) are not
    kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    best, sessions = None, []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = run()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        sessions.append(sum(e.count for e in dev))
        if best is None or sessions[-1] > sessions[best[0]]:
            best = (len(sessions) - 1, dev, out)
    return best[1], best[2], sessions


def _by_kind(dev):
    """Device ms of profiled kernels by kind, from their names: PyTorch's
    elementwise kernels, pooling, reductions, and the rest (convolutions,
    GEMMs and the port's kernels)."""
    kinds = {"elementwise": 0.0, "pooling": 0.0, "reduction": 0.0,
             "other": 0.0}
    for e in dev:
        kind = next((k for k, word in (("elementwise", "elementwise"),
                                       ("pooling", "pool"),
                                       ("reduction", "reduce"))
                     if word in e.key), "other")
        kinds[kind] += getattr(e, "self_device_time_total", 0) / 1e3
    return kinds


def _profile(run):
    """``run()`` (which returns its wall seconds) under torch.profiler, from
    the most complete of three sessions (_device_events): its wall time,
    the device time its kernels sum to, the idle share, how many kernels it
    launched, how many of them were each of the port's kernels (device
    kernels whose name holds the kernel's), and the eight that took the
    most time."""
    dev, wall, sessions = _device_events(run)
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) for e in dev)
    top = sorted(dev, key=lambda e: -getattr(e, "self_device_time_total", 0))[:8]
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3 if dev else None,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3) if dev else None,
            "kernels": sum(e.count for e in dev),
            "profile_sessions_kernels": sessions,
            "device_ms_by_kind": _by_kind(dev),
            "port_kernels": {name: sum(e.count for e in dev if name in e.key)
                             for name in ("flash_attention", "attn_bwd",
                                          "flash_decode", "ssd_", "ssd_bwd")},
            "top_kernels": [{"name": e.key[:60], "count": e.count,
                             "ms": getattr(e, "self_device_time_total", 0) / 1e3}
                            for e in top]}


def _profile_infer(jm, b):
    """One INFER of bucket ``b`` under torch.profiler (see _profile)."""
    return {"bucket": b, **_profile(lambda: jm.run(b))}


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "flash_decode": fd.flash_decode, "ssd_scan": ss.ssd_scan,
            "ssd_scan_bwd": ss.ssd_scan_bwd}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _inputs(cfg, B, S, gen):
    """A prefill batch on the host: the shapes and dtypes of the port's
    configs/shapes.py::prefill_inputs at (B, S), the values drawn from
    ``gen`` (frames and image rows, then tokens: rows at the embedding
    table's std, d_model**-0.5; token ids uniform over the vocab), and the
    length decode continues at (image rows included)."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.shapes import prefill_inputs
    spec = prefill_inputs(cfg, ShapeSpec("prefill", "prefill", S, B))
    batch = {}
    for k, t in sorted(spec.items(), key=lambda kv: kv[1].is_floating_point(),
                       reverse=True):      # the rows first
        if t.is_floating_point():
            batch[k] = (torch.randn(t.shape, generator=gen)
                        * cfg.d_model ** -0.5).to(t.dtype)
        else:
            batch[k] = torch.randint(0, cfg.vocab_size, t.shape,
                                     generator=gen, dtype=t.dtype)
    n_tok = batch["tokens"].shape[1]
    return batch, S if cfg.modality == "image_patches" else n_tok


def _prefill_smoke_against_cpu(arch):
    """Smoke-size prefill (B=2, S=24: seamless 24 frames and tokens, llava
    24 rows of which 8 image rows; 8 more cache slots) then two decode
    steps, on the card (kernels) and on the CPU (plain versions), same
    weights and inputs. The logits of each step are held to
    tests/test_torch_prefill.py's bounds, with the CPU run as the
    reference: 1e-4 x max(|ref|, 1) in f32; in bf16 2e-2 x max(|ref|, 1)
    plus twice the CPU run's own bf16-vs-f32 error."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_map
    cfg = get_smoke_config(arch)
    bundle = get_bundle(cfg)
    gen = torch.Generator().manual_seed(2)
    params0 = bundle.init(gen)
    batch, start = _inputs(cfg, 2, 24, gen)
    dec = torch.randint(0, cfg.vocab_size, (2, 2), generator=gen)
    V = cfg.vocab_size

    def run(dev, dtype):
        cast = lambda t: (t.to(dev, copy=True).to(dtype)      # noqa: E731
                          if t.dtype == torch.bfloat16 else t.to(dev, copy=True))
        p = tree_map(cast, params0)
        with torch.no_grad():
            logits, cache = bundle.prefill(p, tree_map(cast, batch),
                                           cache_len=start + 8)
            steps = [logits]
            for i in range(2):
                logits, cache = bundle.decode(
                    p, cache, dec[:, i:i + 1].to(dev), start + i)
                steps.append(logits)
        return [t[..., :V].float().cpu() for t in steps]

    cpu32 = run("cpu", torch.float32)
    res = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        ref = cpu32 if dtype == torch.float32 else run("cpu", dtype)
        got = run("cuda", dtype)
        errs = []
        for step, (g, r, r32) in enumerate(zip(got, ref, cpu32)):
            err = (g - r).abs().max().item()
            bound = tol * max(r.abs().max().item(), 1.0)
            if dtype == torch.bfloat16:
                bound += 2 * (r - r32).abs().max().item()
            if not err <= bound:
                die("prefill", f"{arch} smoke {dtype} step {step} on the "
                               f"card vs CPU: logits {err} > {bound}")
            errs.append({"err": err, "bound": bound})
        res[str(dtype).split(".")[-1]] = errs
    return res


# projections laid out (d_model, heads, head_dim): the reference's init
# takes shape[-2], the head count, as their fan-in
HEAD_PROJ = ("w_q", "w_k", "w_v", "w_x", "w_z")


def _conditioned(params, cfg):
    """The same random weights with the head projections rescaled to
    1/sqrt(d_model). Under the reference's init rule their std is
    1/sqrt(heads): at qwen2-0.5b's full width q and k reach a std of about
    8 and 21, the scores about 170, the softmax is all but one-hot, and
    rounding in the last bit of any sum decides which key wins, so two
    correct computations of the same logits in another order drift apart
    layer by layer."""
    d = cfg.d_model

    def block(p):
        p = dict(p)
        for mixer in ("attn", "ssm"):
            if mixer in p:
                p[mixer] = {k: (v.float() * (v.shape[-2] / d) ** 0.5).to(
                    v.dtype) if k in HEAD_PROJ else v
                    for k, v in p[mixer].items()}
        return p

    return {**params, "stack": tuple(block(p) for p in params["stack"]),
            "leftover": tuple(block(p) for p in params["leftover"])}


def _routed(run, rows):
    """``run()`` with every MoE layer's router probabilities recorded at
    sequence positions ``rows`` of batch row 0, in layer order: (run's
    result, [(len(rows), E) f32 per layer])."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.moe import _router
    seen, apply = [], lm.moe_apply

    def recording(p, cfg, x):
        seen.append(torch.softmax(_router(p, cfg, x)[2][0, rows], dim=-1))
        return apply(p, cfg, x)

    lm.moe_apply = recording
    try:
        return run(), seen
    finally:
        lm.moe_apply = apply


def _flips(ref, got, k):
    """Layers where ``got``'s top-k experts differ from ``ref``'s (one row
    each): the experts, and ref's margin between its k-th and (k+1)-th
    probability."""
    out = []
    for layer, (r, g) in enumerate(zip(ref, got)):
        ro = r.argsort(descending=True, stable=True)
        go = g.argsort(descending=True, stable=True)
        if set(ro[:k].tolist()) != set(go[:k].tolist()):
            out.append({"layer": layer, "ref_experts": ro[:k].tolist(),
                        "experts": go[:k].tolist(),
                        "ref_margin": (r[ro[k - 1]] - r[ro[k]]).item(),
                        "max_prob_diff": (r - g).abs().max().item()})
    return out


def _identity_errors(bundle, params, B, S):
    """(prefill vs train, decode vs train) relative errors of
    tests/test_models_smoke.py::test_decode_matches_full_forward: prefill(S)
    + decode(S) against the train-mode forward over S+1 tokens; and for a
    MoE model the layers whose top-k experts differ from the train
    forward's at the same position."""
    import torch
    cfg = bundle.cfg
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g).cuda()
    V = cfg.vocab_size
    route = _routed if cfg.moe is not None else (
        lambda run, rows: (run(), []))
    with torch.no_grad():
        full, r_train = route(lambda: bundle.train_logits(
            params, {"tokens": toks}), [S - 1, S])
        fref, ref = full[:, S - 1, :V], full[:, S, :V]
        del full
        (plogits, cache), r_pre = route(lambda: bundle.prefill(
            params, {"tokens": toks[:, :S]}, cache_len=S + 8), [S - 1])
        (dlogits, _), r_dec = route(lambda: bundle.decode(
            params, cache, toks[:, S:S + 1], S), [0])
    pref, got = plogits[:, -1, :V], dlogits[:, 0, :V]
    if not all(torch.isfinite(t).all().item() for t in (pref, got)):
        die("prefill", f"{cfg.name}: non-finite prefill or decode logits")
    rel = lambda a, b: ((a - b).abs().max()                      # noqa: E731
                        / b.abs().max().clamp(min=1.0)).item()
    flips = {}
    if cfg.moe is not None:
        k = cfg.moe.top_k
        flips = {"prefill": _flips([r[0] for r in r_train],
                                   [r[0] for r in r_pre], k),
                 "decode": _flips([r[1] for r in r_train],
                                  [r[0] for r in r_dec], k)}
    return rel(pref, fref), rel(got, ref), flips


def _full_forward_identity(bundle, params, B, S):
    """The identity at full width, held within the test's bounds (prefill
    within 1e-3 relative, decode within 0.06) on the conditioned weights;
    on the reference-init weights it is reported, not held (see
    _conditioned). For a MoE model, the routing flips against the train
    forward are reported beside it."""
    rel_p, rel_d, flips = _identity_errors(
        bundle, _conditioned(params, bundle.cfg), B, S)
    if not (rel_p < 1e-3 and rel_d < 0.06):
        die("prefill", f"{bundle.cfg.name} full width B={B} S={S}: prefill "
                       f"vs train {rel_p} (< 1e-3), decode vs train {rel_d} "
                       f"(< 0.06); routing flips against train: {flips}")
    ref_p, ref_d, _ = _identity_errors(bundle, params, B, S)
    return {"B": B, "S": S, "weights": "head projections at 1/sqrt(d_model)",
            "prefill_rel_err": rel_p, "prefill_bound": 1e-3,
            "decode_rel_err": rel_d, "decode_bound": 0.06,
            **({"routing_flips": flips} if flips else {}),
            "reference_init_not_held": {"prefill_rel_err": ref_p,
                                        "decode_rel_err": ref_d}}


def _path_config(arch):
    """The config a prefill path runs: the published one, qwen3-moe's depth
    cut to MOE_LAYERS."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, num_layers=MOE_LAYERS)
    return cfg


def _prefill_model(arch):
    """The prefill -> decode path of one full-width model: its launches,
    checks, prefill times and profile."""
    import numpy as np
    import torch
    from repro_torch.distributed.steps import make_decode_step, make_prefill_step
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_bytes, tree_map
    cfg = _path_config(arch)
    bundle = get_bundle(cfg)
    t0 = time.perf_counter()
    if arch in HOST_DRAWN:
        params = tree_map(lambda t: t.cuda(),
                          bundle.init(torch.Generator().manual_seed(0)))
    else:
        params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pattern, n_groups, leftover = cfg.pattern_split()
    kinds = pattern * n_groups + leftover
    attn_layers = sum(k in ("attn", "local") for k in kinds)
    cross_layers = attn_layers if cfg.is_encdec else 0
    per_prefill = {"flash_attention": attn_layers + cross_layers
                   + (cfg.enc_layers if cfg.is_encdec else 0),
                   "ssd_scan": kinds.count("ssm")}
    per_step = attn_layers + cross_layers
    shapes = PREFILL_PATHS[arch]
    decode = make_decode_step(cfg)
    g = torch.Generator().manual_seed(1)
    batches = {bs: _inputs(cfg, *bs, g) for bs in shapes}
    steps = {bs: make_prefill_step(cfg, cache_len=start + N_DECODE)
             for bs, (_, start) in batches.items()}

    _zero_counts()                          # the main path's run starts
    generated = {}
    for bs, (batch, start) in batches.items():
        tok, cache = steps[bs](params, batch)
        out = [tok]
        for i in range(N_DECODE):
            tok, cache = decode(params, cache, tok, start + i)
            out.append(tok)
        generated[bs] = torch.cat(out, dim=1).cpu()
        del cache
    torch.cuda.synchronize()
    launches = _read_counts()               # ... and ends
    n = len(shapes)
    want = {"flash_attention": per_prefill["flash_attention"] * n,
            "flash_attention_bwd": 0,
            "ssd_scan": per_prefill["ssd_scan"] * n, "ssd_scan_bwd": 0,
            "flash_decode": per_step * N_DECODE * n}
    for (B, S), toks in generated.items():
        if toks.shape != (B, N_DECODE + 1) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            die("prefill", f"{arch} B={B} S={S}: bad greedy tokens "
                           f"{toks.shape}")
    if launches != want:
        die("prefill", f"{arch}: launches {launches}, expected {want}")

    times = {}
    for bs, (batch, _) in batches.items():
        secs = [_wall_s(lambda: steps[bs](params, batch))
                for _ in range(PREFILL_REPS.get(arch, 3))]
        times[f"{bs[0]}x{bs[1]}"] = {
            "n": len(secs), "p50_ms": float(np.median(secs)) * 1e3,
            "min_ms": min(secs) * 1e3, "max_ms": max(secs) * 1e3}
    B, S = shapes[0]
    res = {"phase": "prefill", "ok": True, "model": arch,
           "layers": cfg.num_layers,
           "encoder_layers": cfg.enc_layers if cfg.is_encdec else 0,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "weights_bytes": tree_bytes(params),
           "drawn_on": "host" if arch in HOST_DRAWN else "card",
           "init_s": t_init, "shapes": [list(bs) for bs in shapes],
           "inputs": {f"{b}x{s}": {k: list(v.shape) for k, v in batch.items()}
                      for (b, s), (batch, _) in batches.items()},
           "decode_steps": N_DECODE, "launches": launches,
           "launches_expected": want,
           "launches_per_prefill": per_prefill,
           "launches_per_decode_step": {"flash_decode": per_step},
           "prefill_ms": times}
    if arch in IDENTITY_ARCHS:
        res["identity"] = _full_forward_identity(bundle, params, B, S)
    res["smoke_card_vs_cpu"] = _prefill_smoke_against_cpu(arch)
    res["profile"] = _profile(lambda: _wall_s(
        lambda: steps[(B, S)](params, batches[(B, S)][0])))
    emit(res)
    del params
    torch.cuda.empty_cache()
    return res


def phase_prefill():
    res = {arch: _prefill_model(arch) for arch in PREFILL_PATHS}
    for arch in SMOKE_ARCHS:
        if arch not in res:                 # smoke size only
            res[arch] = {"phase": "prefill", "ok": True, "model": arch,
                         "smoke_card_vs_cpu": _prefill_smoke_against_cpu(arch)}
            emit(res[arch])
    return res


def _train_smoke_against_cpu(arch):
    """One smoke-size train step of ``arch`` (the config's optimizer;
    gemma2-27b: window 16, attention and final softcaps, Adafactor;
    mamba2-130m: 2 SSD layers, chunk 16 over 32 tokens, AdamW) on the card
    (its kernels, forward and backward) against the same step on the CPU
    (plain versions), same batch, every leaf's gradient read back through
    the optimizer's state.

    In f32 (TF32 off), on the reference's init: loss within 1e-4 relative,
    grad_norm within 1e-3 relative, each leaf's gradient within 3e-4 of its
    largest element plus 1e-6 of the model's largest (the CPU tests' bound,
    tests/test_torch_train_dense.py), every updated weight within 1e-5 of
    the optimizer's update of the card's own gradients recomputed on the
    CPU, and, where the update is proportional to the gradient (Adafactor,
    at lr 1e-3), of the CPU's step (AdamW's first update is lr times the
    gradient's sign, which an element near zero may flip).

    In bf16 (the model's f32 leaves kept in f32, as its init makes them)
    the step runs on the same weights with the head projections at
    1/sqrt(d_model) (_conditioned) and is held to the CPU's f32 step on
    them. On the reference's init the scores are large and the softmax all
    but one-hot, so bf16 rounding decides which key wins and the CPU's own
    bf16 gradients lie far from its f32 ones (printed as
    ``control_reference_init``): no bf16 bound there could tell a fault from
    rounding. On the conditioned weights the CPU's bf16 step, run as the
    control, lies a few percent from f32 per leaf (printed as
    ``control_max_leaf_rel_err``). So: loss within 1e-3 and grad_norm
    within 1e-2 relative; each leaf's gradient within 5e-2 of the f32
    gradient's norm (a gradient reversed, dropped or sent to another leaf
    errs by 100% or more). The updated bf16 weights are held to the
    optimizer's update of the card's own gradients, recomputed on the CPU
    from the same weights: within one bf16 spacing (2^-7 of the value; f32
    arithmetic in another order may round to the neighbouring value). The
    f32 step cannot stand in for them: bf16 spaces weights more widely than
    lr, and a gradient element near zero may change sign."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models.registry import get_bundle
    from repro_torch.training.optimizer import Optimizer, get_optimizer
    from repro_torch.utils import tree_leaves, tree_map
    cfg = get_smoke_config(arch)
    init = get_bundle(cfg).init(torch.Generator().manual_seed(4))
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", 32, 4), seed=0).batch(0)
    inner = get_optimizer(cfg.optimizer)

    def update(grads, state, params, step):     # hands the gradients back
        new_params, new_state = inner.update(grads, state["opt"], params,
                                             step)
        return new_params, {"opt": new_state, "grads": grads}

    opt = Optimizer(inner.name, inner.spec, lambda p: {"opt": inner.init(p)},
                    update)

    def cast(params, dtype, dev="cpu"):     # f32 leaves (mamba2's a_log,
        return tree_map(lambda t: t.to(     # d_skip, norm) stay f32
            dev, torch.float32 if t.dtype == torch.float32 else dtype,
            copy=True), params)

    def run(params0, dev, dtype):
        p = cast(params0, dtype, dev)
        newp, state, m = make_train_step(cfg, opt, device=dev)(
            p, opt.init(p), batch, 0)
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "w": [t.float().cpu() for t in tree_leaves(newp)],
                "g": [t.float().cpu() for t in tree_leaves(state["grads"])],
                "grads": tree_map(lambda t: t.cpu(), state["grads"])}

    def scalars(got, ref, tols):
        return {k: {"cpu": ref[k], "card": got[k],
                    "err": abs(got[k] - ref[k]), "bound": tol * abs(ref[k])}
                for k, tol in tols.items()}

    def leaf_rel(a, b):
        return [((x - y).norm() / y.norm().clamp(min=1e-30)).item()
                for x, y in zip(a, b)]

    res = {}
    ref, got = run(init, "cpu", torch.float32), run(init, "cuda",
                                                    torch.float32)
    r = scalars(got, ref, {"loss": 1e-4, "grad_norm": 1e-3})
    top = max(g.abs().max().item() for g in ref["g"])
    gerr = max(((a - b).abs().max() / (3e-4 * b.abs().max() + 1e-6 * top)
                ).item() for a, b in zip(got["g"], ref["g"]))
    werr = max((a - b).abs().max().item() for a, b in zip(got["w"], ref["w"]))
    p32 = cast(init, torch.float32)
    own, _ = inner.update(got["grads"], inner.init(p32), p32, 0)
    werr_own = max((a - b).abs().max().item()
                   for a, b in zip(got["w"], tree_leaves(own)))
    proportional = cfg.optimizer == "adafactor"
    r["grads"] = {"max_err_over_bound": gerr}
    r["weights"] = {"max_abs_err": werr, "held": proportional,
                    "max_abs_err_own_grads": werr_own, "bound": 1e-5}
    r["control_reference_init"] = {"max_leaf_rel_err": max(leaf_rel(
        run(init, "cpu", torch.bfloat16)["g"], ref["g"]))}
    res["float32"] = r
    if not (all(v["err"] <= v["bound"] for k, v in r.items()
                if k in ("loss", "grad_norm")) and gerr <= 1
            and werr_own <= 1e-5 and (werr <= 1e-5 or not proportional)):
        die("train", f"{arch} smoke train step, card vs CPU, f32: {r}")

    cond = _conditioned(init, cfg)
    ref = run(cond, "cpu", torch.float32)
    ctl, got = run(cond, "cpu", torch.bfloat16), run(cond, "cuda",
                                                     torch.bfloat16)
    r = scalars(got, ref, {"loss": 1e-3, "grad_norm": 1e-2})
    g_card, g_ctl = leaf_rel(got["g"], ref["g"]), leaf_rel(ctl["g"], ref["g"])
    p16 = cast(cond, torch.bfloat16)
    want, _ = inner.update(got["grads"], inner.init(p16), p16, 0)
    w_err = max(((a - b.float()).abs() / (2 ** -7 * b.float().abs())
                 .clamp(min=1e-30)).max().item()
                for a, b in zip(got["w"], tree_leaves(want)))
    r["grads"] = {"max_leaf_rel_err": max(g_card), "bound": 5e-2,
                  "control_max_leaf_rel_err": max(g_ctl)}
    r["weights"] = {"max_err_in_bf16_spacings": w_err, "bound": 1.0,
                    "max_leaf_rel_err_from_f32_step": max(
                        leaf_rel(got["w"], ref["w"]))}
    res["bfloat16_conditioned"] = r
    if not (all(v["err"] <= v["bound"] for k, v in r.items()
                if k in ("loss", "grad_norm"))
            and max(g_card) <= 5e-2 and w_err <= 1.0):
        die("train", f"{arch} smoke train step, card vs CPU's f32, "
                     f"bf16 on conditioned weights: {r}")
    return res


def _ssm_layers(cfg):
    """The Mamba2 layers of a config (each launches ssd_scan once per
    forward)."""
    pattern, n_groups, leftover = cfg.pattern_split()
    return sum(k == "ssm" for k in pattern * n_groups + leftover)


def _train_launches(cfg, n_mb):
    """The launches of one train step in ``n_mb`` microbatches: every
    attention (Mamba2) layer of every microbatch runs the forward kernel
    once, and once more when remat recomputes its group in the backward;
    the backward kernel once."""
    fwd = n_mb * (2 if cfg.remat else 1)
    attn, ssm = _attn_layers(cfg), _ssm_layers(cfg)
    return {"flash_attention": attn * fwd, "flash_attention_bwd": attn * n_mb,
            "flash_decode": 0, "ssd_scan": ssm * fwd,
            "ssd_scan_bwd": ssm * n_mb}


def _train_path(arch, B, S):
    """Full-width ``arch`` training through the entry point a user calls
    (repro_torch.launch.train.train) at (B, S), resumed from its first
    checkpoint; then timed and profiled steps, the TRAIN_LONG steps and the
    smoke-size card-vs-CPU check. The launch counts are read from zero just
    before the main run and just after."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.steps import (make_train_step,
                                               microbatches_for)
    from repro_torch.launch.train import train
    from repro_torch.models.params import param_count
    from repro_torch.models.registry import get_bundle
    from repro_torch.training.optimizer import get_optimizer
    from repro_torch.utils import tree_map
    cfg = get_config(arch)
    n_mb = microbatches_for(cfg, B, 1)
    want = _train_launches(cfg, n_mb)
    kw = dict(smoke=False, batch=B, seq=S, log_every=1, device="cuda")
    tmp = tempfile.mkdtemp(dir=ROOT / "build", prefix="chip_smoke_train_")
    try:
        _zero_counts()                      # the main path's run starts
        t0 = time.perf_counter()
        losses = train(arch, steps=TRAIN_STEPS, ckpt_dir=tmp,
                       ckpt_every=TRAIN_CKPT_EVERY, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _read_counts()           # ... and ends
        per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
        if per_step != want:
            die("train", f"{arch}: launches per step {per_step}, expected "
                         f"{want}")
        if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()):
            die("train", f"{arch}: losses {losses}: not {TRAIN_STEPS} "
                         f"finite values")
        for d in (Path(tmp), Path(tmp) / "opt"):    # resume from the first
            shutil.rmtree(d / f"step_{TRAIN_STEPS}")
        t0 = time.perf_counter()
        resumed = train(arch, steps=TRAIN_STEPS, ckpt_dir=tmp,
                        ckpt_every=100, **kw)
        resume_s = time.perf_counter() - t0
        diff = abs(resumed[-1] - losses[-1])
        bound = 1e-3 + 1e-3 * abs(losses[-1])     # the reference test's
        if len(resumed) != TRAIN_STEPS - TRAIN_CKPT_EVERY or not diff <= bound:
            die("train", f"{arch}: resumed from step {TRAIN_CKPT_EVERY}: "
                         f"losses {resumed}, last {diff} from the "
                         f"uninterrupted run's {losses[-1]} (bound {bound})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # The timed steps start from the same weights with the head projections
    # at 1/sqrt(d_model) (_conditioned): under the reference's init rule the
    # full-width model's gradient norm grows steeply with depth (both
    # packages: tests/test_torch_train_full_width.py) and a few AdamW steps
    # do not move its loss, so the check that the step learns is held on
    # these. They train on one batch,
    # repeated, whose loss must fall by more than 0.5, the margin of
    # tests/test_training.py::test_loss_decreases_adamw.
    bundle = get_bundle(cfg)
    opt = get_optimizer(cfg.optimizer)
    step = make_train_step(cfg, opt, microbatches=n_mb, device="cuda")
    src = SyntheticLM(cfg, ShapeSpec("custom_train", "train", S, B), seed=0)
    batch = src.batch(0)
    host = bundle.init(torch.Generator().manual_seed(0))   # train()'s
    params = tree_map(lambda t: t.cuda(), host)
    init_grad_norm = float(step(params, opt.init(params), batch, 0)[2][
        "grad_norm"])                       # the main path's first step
    params = tree_map(lambda t: t.cuda(), _conditioned(host, cfg))
    del host
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    secs, norms, timed_losses = [], [], []
    for i in range(TRAIN_TIMED):
        out = {}
        secs.append(_wall_s(lambda: out.update(
            r=step(params, state, batch, i))))
        params, state, m = out["r"]
        norms.append(float(m["grad_norm"]))
        timed_losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not timed_losses[-1] < timed_losses[0] - 0.5:
        die("train", f"{arch}: {TRAIN_TIMED} steps on one batch: losses "
                     f"{timed_losses} do not fall by 0.5")
    _zero_counts()
    prof = _profile(lambda: _wall_s(lambda: step(params, state, batch, 0)))
    prof_launches = _read_counts()          # three profiled sessions
    if {k: n / 3 for k, n in prof_launches.items()} != want:
        die("train", f"{arch}: launches in 3 profiled steps "
                     f"{prof_launches}, expected 3 x {want}")

    B2, S2 = TRAIN_LONG
    src2 = SyntheticLM(cfg, ShapeSpec("custom_train", "train", S2, B2), seed=0)
    step2 = make_train_step(cfg, opt, microbatches=microbatches_for(cfg, B2, 1),
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    long_secs, long_losses = [], []
    for i in range(TRAIN_LONG_STEPS):
        batch, out = src2.batch(i), {}
        long_secs.append(_wall_s(lambda: out.update(
            r=step2(params, state, batch, i))))
        params, state, m = out["r"]
        long_losses.append(float(m["loss"]))
    long_peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(long_losses).all():
        die("train", f"{arch}: (2, 2048) losses {long_losses}")
    del params, state
    torch.cuda.empty_cache()
    p50 = float(np.median(secs))
    res = {"phase": "train", "ok": True, "model": arch,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "optimizer": cfg.optimizer,
           "microbatches": n_mb, "remat": cfg.remat, "batch": B, "seq": S,
           "params": param_count(bundle.spec()),
           "losses": losses, "loss_first": losses[0], "loss_last": losses[-1],
           "run_s": run_s, "resumed_losses": resumed, "resume_s": resume_s,
           "resume_last_loss_diff": diff, "resume_bound": bound,
           "launches": launches, "launches_per_step": per_step,
           "launches_per_step_expected": want,
           "timed_steps": {"n": len(secs), "p50_ms": p50 * 1e3,
                           "min_ms": min(secs) * 1e3,
                           "max_ms": max(secs) * 1e3},
           "tokens_per_s": B * S / p50,
           "grad_norm_reference_init": init_grad_norm,
           "timed_losses": timed_losses, "grad_norms": norms,
           "peak_device_bytes": peak, "profile_step": prof,
           "long": {"batch": B2, "seq": S2, "steps": TRAIN_LONG_STEPS,
                    "step_ms": [x * 1e3 for x in long_secs],
                    "tokens_per_s": B2 * S2 / min(long_secs),
                    "losses": long_losses, "peak_device_bytes": long_peak},
           "smoke_card_vs_cpu": _train_smoke_against_cpu(TRAIN_SMOKE[arch])}
    emit(res)
    return res


def phase_train():
    """Every train path (TRAIN_PATHS), each read on its own: {arch: its
    result}."""
    return {arch: _train_path(arch, B, S)
            for arch, (B, S) in TRAIN_PATHS.items()}


def _whole(t):
    """A DTensor's local tensor, which on one rank is the whole tensor."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _tree_diff(a, b):
    """(bit for bit equal, largest |a - b|) over two trees of one
    structure."""
    import torch
    from repro_torch.utils import tree_leaves
    pairs = [(x, _whole(y)) for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return (all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs),
            max((x.float() - y.float()).abs().max().item() for x, y in pairs))


def _all_replicate(step):
    """Whether every argument of ``step`` is laid out Replicate (as every
    placement on a one-rank mesh is)."""
    from repro_torch.utils import tree_leaves_like
    return all(p.is_replicate()
               for a, sh in zip(step.abstract, step.in_shardings)
               if sh is not None for pl in tree_leaves_like(sh, a)
               for p in pl)


def _step_peak(step):
    """(peak bytes allocated during one call of ``step``, above what was
    allocated before it): the result is dropped before returning."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak - base


def _sharded_train(arch, mesh, params, optimizer=None, steps=None):
    """SHARDED_TRAIN[arch]'s steps (or ``steps``) of build_sharded_step
    against make_train_step from ``params``, with the config's optimizer
    (or ``optimizer``): launches, per-step loss and grad_norm, the final
    weights and optimizer state bit for bit, both steps' peak memory, then
    both steps' times."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.steps import (build_sharded_step,
                                               make_train_step,
                                               microbatches_for)
    from repro_torch.training.optimizer import get_optimizer
    cfg = get_config(arch)
    if optimizer is not None:
        cfg = dataclasses.replace(cfg, optimizer=optimizer)
    (B, S), n = SHARDED_TRAIN[arch]
    n = steps or n
    shape = ShapeSpec("custom_train", "train", S, B)
    opt = get_optimizer(cfg.optimizer)
    n_mb = microbatches_for(cfg, B, 1)
    plain = make_train_step(cfg, opt, microbatches=n_mb, device="cuda")
    sharded = build_sharded_step(cfg, mesh, shape)
    want = _train_launches(cfg, n_mb)
    src = SyntheticLM(cfg, shape, seed=0)
    batches = [src.batch(i) for i in range(n)]
    state = opt.init(params)
    p, s, ref = params, state, []
    for i, b in enumerate(batches):
        p, s, m = plain(p, s, b, i)
        ref.append([float(m["loss"]), float(m["grad_norm"])])
    _zero_counts()                          # the sharded run starts
    sp, ss, got = params, state, []
    for i, b in enumerate(batches):
        sp, ss, m = sharded.fn(sp, ss, b, i)
        got.append([float(_whole(m["loss"])), float(_whole(m["grad_norm"]))])
    torch.cuda.synchronize()
    launches = _read_counts()               # ... and ends
    per_step = {k: v / n for k, v in launches.items()}
    if per_step != want:
        die("sharded", f"{arch} train: launches per step {per_step}, "
                       f"expected {want}")
    p_equal, p_diff = _tree_diff(p, sp)
    s_equal, s_diff = _tree_diff(s, ss)
    bit_equal = got == ref and p_equal and s_equal
    loss_diff = max(abs(g[0] - r[0]) for g, r in zip(got, ref))
    norm_rel = max(abs(g[1] - r[1]) / r[1] for g, r in zip(got, ref))
    # on one rank the sharded step's arithmetic is the plain step's
    if not bit_equal:
        die("sharded", f"{arch} train ({cfg.optimizer}): not bit-equal to "
                       f"the plain step: sharded {got} vs plain {ref}, "
                       f"weights {p_diff}, optimizer state {s_diff}")
    # one step of each from the same trees, the other's results alive in
    # both: the peak above what was allocated before the call
    peak = {"plain": _step_peak(lambda: plain(p, s, batches[0], 0)),
            "sharded": _step_peak(lambda: sharded.fn(sp, ss, batches[0], 0))}
    peak_rel = abs(peak["sharded"] - peak["plain"]) / peak["plain"]
    if peak_rel > SHARDED_PEAK_REL:
        die("sharded", f"{arch} train ({cfg.optimizer}): peak {peak} bytes, "
                       f"sharded vs plain {peak_rel:.3f} relative > "
                       f"{SHARDED_PEAK_REL}")
    secs = {"plain": [], "sharded": []}
    for _ in range(SHARDED_TIMED):          # alternating, on one batch
        secs["plain"].append(_wall_s(lambda: plain(p, s, batches[0], 0)))
        secs["sharded"].append(_wall_s(
            lambda: sharded.fn(sp, ss, batches[0], 0)))
    return {"batch": B, "seq": S, "steps": n, "microbatches": n_mb,
            "optimizer": cfg.optimizer, "mode": sharded.rules["_mode"],
            "peak_bytes": peak, "peak_rel_diff": peak_rel,
            "all_replicate": _all_replicate(sharded),
            "losses": got, "plain_losses_grad_norms": ref,
            "bit_equal": bit_equal, "max_loss_diff": loss_diff,
            "max_grad_norm_rel_diff": norm_rel,
            "max_param_diff": p_diff, "max_opt_state_diff": s_diff,
            "launches": launches, "launches_per_step": per_step,
            "launches_per_step_expected": want,
            "step_ms": {k: {"p50": float(np.median(v)) * 1e3,
                            "min": min(v) * 1e3, "max": max(v) * 1e3,
                            "n": len(v)} for k, v in secs.items()}}


def _sharded_serve(arch, mesh, params):
    """Prefill at SHARDED_PREFILL and N_DECODE greedy decode steps through
    build_sharded_step against the plain steps from ``params``: launches,
    every token and the final cache, bit for bit; per-call times."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.steps import (build_sharded_step,
                                               make_decode_step,
                                               make_prefill_step)
    cfg = get_config(arch)
    B, S = SHARDED_PREFILL
    batch, start = _inputs(cfg, B, S, torch.Generator().manual_seed(1))
    L = start + N_DECODE
    pre = build_sharded_step(cfg, mesh, ShapeSpec("prefill", "prefill", S, B),
                             cache_len=L)
    dec = build_sharded_step(cfg, mesh, ShapeSpec("decode", "decode", L, B))
    plain_pre = make_prefill_step(cfg, cache_len=L)
    plain_dec = make_decode_step(cfg)
    secs = {k: [] for k in ("plain_prefill", "sharded_prefill",
                            "plain_decode", "sharded_decode")}

    def run(prefill, decode, kind):
        out = {}
        secs[f"{kind}_prefill"].append(_wall_s(
            lambda: out.update(r=prefill(params, batch))))
        tok, cache = out["r"]
        toks = [_whole(tok)]
        for i in range(N_DECODE):
            secs[f"{kind}_decode"].append(_wall_s(
                lambda: out.update(r=decode(params, cache, tok, start + i))))
            tok, cache = out["r"]
            toks.append(_whole(tok))
        return torch.cat(toks, dim=1).cpu(), cache

    want_toks, want_cache = run(plain_pre, plain_dec, "plain")
    _zero_counts()                          # the sharded run starts
    got_toks, got_cache = run(pre.fn, dec.fn, "sharded")
    torch.cuda.synchronize()
    launches = _read_counts()               # ... and ends
    layers = _attn_layers(cfg)
    want = {"flash_attention": layers, "flash_attention_bwd": 0,
            "flash_decode": layers * N_DECODE, "ssd_scan": 0,
            "ssd_scan_bwd": 0}
    if launches != want:
        die("sharded", f"{arch} serve: launches {launches}, expected {want}")
    cache_equal, cache_diff = _tree_diff(want_cache, got_cache)
    tokens_equal = torch.equal(want_toks, got_toks)
    if not (tokens_equal and cache_equal):
        die("sharded", f"{arch} serve: tokens {got_toks.tolist()} vs plain "
                       f"{want_toks.tolist()}; cache max diff {cache_diff}")
    for _ in range(2):                      # two more prefills of each
        secs["plain_prefill"].append(_wall_s(lambda: plain_pre(params, batch)))
        secs["sharded_prefill"].append(_wall_s(lambda: pre.fn(params, batch)))
    return {"batch": B, "seq": S, "cache_len": L, "decode_steps": N_DECODE,
            "prefill_mode": pre.rules["_mode"],
            "decode_mode": dec.rules["_mode"],
            "tokens_bit_equal": tokens_equal, "cache_bit_equal": cache_equal,
            "cache_max_diff": cache_diff, "tokens": got_toks.tolist(),
            "launches": launches, "launches_expected": want,
            "ms": {k: {"p50": float(np.median(v)) * 1e3, "n": len(v)}
                   for k, v in secs.items()}}


def _vocab_shards(arch, params):
    """The vocab-parallel layer's per-shard bodies on the card: ``arch``'s
    embedding table and the logits of one SHARDED_TRAIN batch (full width,
    ``params``) cut into VOCAB_SHARDS vocab shards and merged here as the
    model axis's collectives merge them (``embed_split``,
    ``token_ll_split``), against the plain lookup (bit for bit) and the
    plain loss and its logits gradient (VOCAB_TOL relative); two calls of
    each, bit for bit; device ms of the lookup and of the loss's forward
    and backward, shards beside plain, in turns."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import vocab
    from repro_torch.distributed.steps import _token_ll
    from repro_torch.models.registry import get_bundle
    cfg = get_config(arch)
    (B, S), _ = SHARDED_TRAIN[arch]
    n = VOCAB_SHARDS
    batch = SyntheticLM(cfg, ShapeSpec("custom_train", "train", S, B),
                        seed=0).batch(0)
    tokens, targets = (torch.as_tensor(batch[k]).cuda()
                       for k in ("tokens", "targets"))
    table = params["embed"]["embedding"]
    rows = [vocab.embed_split(table, tokens, n) for _ in range(2)]
    want_rows = table[tokens]
    lookup_equal = all(r.dtype == want_rows.dtype
                       and torch.equal(r, want_rows) for r in rows)
    with torch.no_grad():
        logits = get_bundle(cfg).train_logits(params, {"tokens": tokens})

    def plain_ll(l, t):
        return _token_ll(l, t)

    def split_ll(l, t):
        return vocab.token_ll_split(l, t, n)

    def loss_grad(ll):
        l = logits.detach().float().requires_grad_()
        loss = -ll(l, targets).mean()
        loss.backward()
        return loss.detach(), l.grad

    want = loss_grad(plain_ll)
    got = [loss_grad(split_ll) for _ in range(2)]
    loss_rel = abs(got[0][0].item() - want[0].item()) / abs(want[0].item())
    grad_rel = ((got[0][1] - want[1]).abs().max()
                / want[1].abs().max()).item()
    repeats_equal = all(torch.equal(a, b) for a, b in zip(*got))
    ok = (lookup_equal and repeats_equal and loss_rel <= VOCAB_TOL
          and grad_rel <= VOCAB_TOL and bool(torch.isfinite(got[0][1]).all()))
    if not ok:
        die("sharded", f"{arch} vocab shards: lookup bit-equal "
                       f"{lookup_equal}, repeats {repeats_equal}, loss rel "
                       f"{loss_rel}, logits grad rel {grad_rel} (bound "
                       f"{VOCAB_TOL})")
    del got, want
    ms = {k: [] for k in ("plain_loss", "split_loss", "plain_lookup",
                          "split_lookup")}
    for _ in range(VOCAB_TURNS):
        ms["plain_loss"].append(cuda_ms(lambda: loss_grad(plain_ll), 5, 2))
        ms["split_loss"].append(cuda_ms(lambda: loss_grad(split_ll), 5, 2))
        ms["plain_lookup"].append(cuda_ms(lambda: table[tokens], 20, 5))
        ms["split_lookup"].append(cuda_ms(
            lambda: vocab.embed_split(table, tokens, n), 20, 5))
    return {"batch": B, "seq": S, "shards": n,
            "vocab_padded": cfg.vocab_padded,
            "logits_bytes": logits.numel() * 4,
            "lookup_bit_equal": lookup_equal,
            "repeats_bit_equal": repeats_equal, "loss_rel_err": loss_rel,
            "logits_grad_rel_err": grad_rel, "tol": VOCAB_TOL,
            "device_ms": {k: {"median": float(np.median(v)), "all": v}
                          for k, v in ms.items()}}


def _sharded_launcher(train_res):
    """qwen2-0.5b through launch.train.train(mesh_shape=(1, 1)): its
    launches, its losses against the train phase's plain launcher's (same
    seed and data), and a resume from its first checkpoint, bit for bit."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.steps import microbatches_for
    from repro_torch.launch.train import train
    arch = "qwen2-0.5b"
    B, S = TRAIN_PATHS[arch]
    cfg = get_config(arch)
    want = _train_launches(cfg, microbatches_for(cfg, B, 1))
    n = SHARDED_LAUNCH_STEPS
    kw = dict(smoke=False, batch=B, seq=S, log_every=1, device="cuda",
              mesh_shape=(1, 1))
    tmp = tempfile.mkdtemp(dir=ROOT / "build", prefix="chip_smoke_sharded_")
    try:
        _zero_counts()                      # the meshed launcher starts
        losses = train(arch, steps=n, ckpt_dir=tmp,
                       ckpt_every=SHARDED_LAUNCH_CKPT, **kw)
        torch.cuda.synchronize()
        launches = _read_counts()           # ... and ends
        per_step = {k: v / n for k, v in launches.items()}
        if per_step != want:
            die("sharded", f"launcher: launches per step {per_step}, "
                           f"expected {want}")
        for d in (Path(tmp), Path(tmp) / "opt"):
            shutil.rmtree(d / f"step_{n}")
        resumed = train(arch, steps=n, ckpt_dir=tmp, ckpt_every=100, **kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if resumed != losses[SHARDED_LAUNCH_CKPT:]:
        die("sharded", f"launcher: resumed from step {SHARDED_LAUNCH_CKPT}: "
                       f"{resumed}, uninterrupted {losses}")
    plain = train_res[arch]["losses"][:n]
    diff = max(abs(a - b) for a, b in zip(losses, plain))
    if not all(abs(a - b) <= 1e-3 + 1e-3 * abs(b)
               for a, b in zip(losses, plain)):
        die("sharded", f"launcher: losses {losses} vs the plain "
                       f"launcher's {plain}")
    return {"steps": n, "losses": losses, "resumed_losses": resumed,
            "resume_bit_equal": True, "plain_launcher_losses": plain,
            "equal_to_plain_launcher": losses == plain,
            "max_diff_to_plain_launcher": diff, "launches": launches,
            "launches_per_step": per_step}


def _gemm_ms(dev):
    """Device ms of the profiled GEMM kernels (cuBLAS's and CUTLASS's, by
    name) and their count."""
    gemm = [e for e in dev if re.search(r"gemm|xmma|nvjet|cutlass", e.key,
                                        re.I) and "flash" not in e.key]
    return (sum(getattr(e, "self_device_time_total", 0) for e in gemm) / 1e3,
            sum(e.count for e in gemm))


@contextlib.contextmanager
def _drop_log():
    """While open, the dropped (token, expert) pairs of each expert-parallel
    dispatch, one count tensor a call, appended to the list it yields
    (``moe._dispatch_tables`` wrapped)."""
    from repro_torch.models import moe
    log, tables = [], moe._dispatch_tables

    def counted(*args):
        tok, slot = tables(*args)
        log.append((slot < 0).sum())
        return tok, slot
    moe._dispatch_tables = counted
    try:
        yield log
    finally:
        moe._dispatch_tables = tables


def _moe_drop_table(p, cfg, h):
    """(top_p, top_i, kept (N, k) bool) of the expert-parallel path's
    router and dispatch on ``h`` (B, S, d), at its capacity for B*S
    tokens (one chunk)."""
    from repro_torch.models import moe
    x = h.reshape(-1, h.shape[-1])
    _, capacity = moe._capacity(cfg, x.shape[0])
    top_p, top_i, _ = moe._router(p, cfg, x)
    _, slot = moe._dispatch_tables(top_i, cfg.moe.num_experts, capacity)
    return top_p, top_i, slot >= 0


def _masked_dense(p, cfg, h, top_p, top_i, kept):
    """Plain masked-dense MoE: every expert on every token (the dense
    path's products), combined over the kept pairs only, in f32 in top-k
    order."""
    import torch
    import torch.nn.functional as F
    x = h.reshape(-1, h.shape[-1])
    g = torch.einsum("nd,edf->nef", x, p["w_gate"])
    u = torch.einsum("nd,edf->nef", x, p["w_in"])
    y = torch.einsum("nef,efd->ned", F.silu(g.float()).to(x.dtype) * u,
                     p["w_out"])
    chosen = y.gather(1, top_i[..., None].expand(-1, -1, y.shape[-1]))
    w = top_p * kept
    out = chosen[:, 0].float() * w[:, 0:1]
    for j in range(1, cfg.moe.top_k):
        out = out + chosen[:, j].float() * w[:, j:j + 1]
    return out.to(x.dtype).reshape(h.shape)


def _check_expert_blocks(p):
    """``moe._expert_ffn_blocks`` on random bf16 rows with layer ``p``'s
    weights at each of MOE_BLOCKS blocks (an odd count with its last block
    one row short, zero-padded): the first, middle and last blocks' bits
    equal to ``moe._expert_ffn`` on that block alone. Returns MOE_BLOCKS."""
    import torch
    from repro_torch.models import moe
    w = (p["w_gate"], p["w_in"], p["w_out"])
    E, d = w[0].shape[:2]
    R = moe.EXPERT_ROWS
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((E, max(MOE_BLOCKS) * R, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for nb in MOE_BLOCKS:
        xs = x[:, :nb * R].clone()
        short = nb % 2
        if short:
            xs[:, -1] = 0
        y = moe._expert_ffn_blocks(xs[:, :nb * R - short], *w)
        for i in sorted({0, nb // 2, nb - 1}):
            got = y[:, i * R:(i + 1) * R]
            alone = moe._expert_ffn(xs[:, i * R:(i + 1) * R], *w)
            if not torch.equal(got, alone[:, :got.shape[1]]):
                die("sharded", f"{MOE_ARCH} expert products: block {i} of "
                               f"{nb} differs from a call of it alone")
        del xs, y
    return list(MOE_BLOCKS)


def _moe_layers(params):
    """Each MoE layer's weights, in layer order: the stacked groups' (one
    slice of the leading ``layers`` dim each), then the leftover blocks'."""
    from repro_torch.utils import tree_map
    out = []
    for group in params["stack"]:
        if "moe" in group:
            n = next(iter(group["moe"].values())).shape[0]
            out += [tree_map(lambda a, i=i: a[i], group["moe"])
                    for i in range(n)]
    return out + [b["moe"] for b in params["leftover"] if "moe" in b]


def _sharded_moe(mesh):
    """Full-width qwen3-moe-235b-a22b (MOE_LAYERS layers, weights drawn on
    the card) through the (1, 1) mesh, where moe_apply takes the
    expert-parallel path: prefill at PREFILL_SHAPES and N_DECODE greedy
    decode steps through build_sharded_step (launches, the dropped pairs of
    each call); one MoE block against _masked_dense with the same drop
    table (bf16, rtol = atol = 2e-2); two calls bit for bit; a token with
    no dropped pair in calls of MOE_ROWS tokens, bit for bit; the expert
    GEMMs' device time of the MOE_LAYERS blocks on one (1, 2048) input,
    expert-parallel beside dense, in turns."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import (make_rules, replicated,
                                                  use_rules)
    from repro_torch.distributed.steps import build_sharded_step
    from repro_torch.models import moe
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_map
    cfg = _path_config(MOE_ARCH)
    params = get_bundle(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batches = {bs: _inputs(cfg, *bs, g) for bs in PREFILL_SHAPES}
    res = {"model": MOE_ARCH, "layers": cfg.num_layers, "calls": []}
    with _drop_log() as drops:
        _zero_counts()                      # the sharded MoE path starts
        for (B, S), (batch, start) in batches.items():
            L = start + N_DECODE
            pre = build_sharded_step(cfg, mesh, ShapeSpec(
                "prefill", "prefill", S, B), cache_len=L)
            dec = build_sharded_step(cfg, mesh, ShapeSpec(
                "decode", "decode", L, B))
            drops.clear()
            secs = [_wall_s(lambda: pre.fn(params, batch)) for _ in range(3)]
            n_pre = int(sum(drops).item()) // 3
            tok, cache = pre.fn(params, batch)
            toks = [_whole(tok)]
            drops.clear()
            for i in range(N_DECODE):
                tok, cache = dec.fn(params, cache, tok, start + i)
                toks.append(_whole(tok))
            n_dec = int(sum(drops).item())
            toks = torch.cat(toks, dim=1).cpu()
            del cache
            if toks.shape != (B, N_DECODE + 1) or not (
                    (toks >= 0) & (toks < cfg.vocab_size)).all():
                die("sharded", f"{MOE_ARCH} ({B}, {S}): bad tokens")
            res["calls"].append({
                "batch": B, "seq": S, "mode": pre.rules["_mode"],
                "prefill_ms_p50": float(np.median(secs)) * 1e3,
                "prefill_dropped_pairs": n_pre,
                "prefill_pairs": B * S * cfg.moe.top_k * cfg.num_layers,
                "decode_dropped_pairs": n_dec, "tokens": toks.tolist()})
        torch.cuda.synchronize()
        # 4 prefill calls (3 timed, 1 decoded from) per shape
        launches = _read_counts()           # ... and ends
        per_shape = {"flash_attention": 4 * cfg.num_layers,
                     "flash_decode": N_DECODE * cfg.num_layers}
        want = {"flash_attention": per_shape["flash_attention"]
                * len(batches), "flash_attention_bwd": 0,
                "flash_decode": per_shape["flash_decode"] * len(batches),
                "ssd_scan": 0, "ssd_scan_bwd": 0}
        if launches != want:
            die("sharded", f"{MOE_ARCH}: launches {launches}, expected "
                           f"{want}")
        res["launches"], res["launches_expected"] = launches, want

        # one MoE block (layer 0's weights) on the mesh
        layers = _moe_layers(params)
        p = layers[0]
        rules = make_rules(mesh, cfg, "prefill",
                           ShapeSpec("prefill", "prefill", 2048, 1))
        rep = tree_map(lambda t: distribute_tensor(t, mesh, replicated(mesh)),
                       p)

        def block(h):
            with use_rules(mesh, rules), torch.no_grad():
                return _whole(moe.moe_apply(rep, cfg, distribute_tensor(
                    h, mesh, replicated(mesh))))
        # a component every token shares skews the routing, so that some
        # experts overflow their capacity and the block drops pairs
        gen = torch.Generator(device="cuda").manual_seed(7)
        h = (torch.randn((1, max(MOE_ROWS), cfg.d_model), generator=gen,
                         device="cuda")
             + torch.randn((cfg.d_model,), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        h0 = h[:, :MOE_ROWS[0]]
        drops.clear()
        got = block(h0)
        dropped = int(sum(drops).item())
        top_p, top_i, kept = _moe_drop_table(p, cfg, h0)
        want_out = _masked_dense(p, cfg, h0, top_p, top_i, kept)
        err, ok = _allclose_err(got, want_out, TOL["bfloat16"])
        if not ok or not 0 < dropped == int((~kept).sum().item()):
            die("sharded", f"{MOE_ARCH} MoE block against masked dense: "
                           f"max abs err {err}, dropped {dropped} vs "
                           f"{int((~kept).sum().item())}")
        again = block(h0)
        if not torch.equal(got, again):
            die("sharded", f"{MOE_ARCH} MoE block: two calls differ")
        # a token kept in every call: its bits at 2048, 2049 and 1 tokens
        kept_all = kept.all(-1) & _moe_drop_table(p, cfg, h)[2][
            :MOE_ROWS[0]].all(-1)
        t = int(torch.nonzero(kept_all)[0, 0].item())
        at_more = block(h)
        at_one = block(h[:, t:t + 1])
        both = torch.nonzero(kept_all)[:, 0]
        same = (torch.equal(got[0, both], at_more[0, both])
                and torch.equal(got[0, t], at_one[0, 0]))
        if not same:
            die("sharded", f"{MOE_ARCH} MoE block: a kept token's output "
                           f"depends on the token count")
        res["block"] = {
            "tokens": MOE_ROWS[0], "dropped_pairs": dropped,
            "pairs": MOE_ROWS[0] * cfg.moe.top_k,
            "capacity": moe._capacity(cfg, MOE_ROWS[0])[1],
            "max_abs_err_vs_masked_dense": err,
            "tolerance": TOL["bfloat16"], "repeat_bit_equal": True,
            "kept_tokens_in_2048_and_2049": int(kept_all.sum().item()),
            "kept_token_bit_equal_at": list(MOE_ROWS), "token": t,
            "expert_blocks_bit_equal_at": _check_expert_blocks(p)}

        # the expert GEMMs of the MOE_LAYERS blocks on one (1, 2048) input:
        # the expert-parallel path and the dense one, in turns
        reps = [tree_map(lambda t: distribute_tensor(
            t, mesh, replicated(mesh)), q) for q in layers]
        hd = distribute_tensor(h0, mesh, replicated(mesh))

        def ep():
            with use_rules(mesh, rules), torch.no_grad():
                for q in reps:
                    moe.moe_apply(q, cfg, hd)
            torch.cuda.synchronize()

        def dense():
            with torch.no_grad():
                for q in layers:
                    moe.moe_apply(q, cfg, h0)
            torch.cuda.synchronize()
        gemm = {}
        for name, fn in (("dense", dense), ("expert_parallel", ep),
                         ("expert_parallel_2", ep), ("dense_2", dense)):
            fn()
            dev, _, sessions = _device_events(fn)
            ms, n = _gemm_ms(dev)
            gemm[name] = {"gemm_ms": ms, "gemm_kernels": n,
                          "busy_ms": sum(getattr(e, "self_device_time_total",
                                                 0) for e in dev) / 1e3,
                          "profile_sessions_kernels": sessions}
        res["expert_gemms_4_blocks_1x2048"] = gemm
        res["dense_expert_gemms_ms_pr11"] = 50.30
    del params
    torch.cuda.empty_cache()
    return res


def phase_sharded(train_res):
    """The sharded phase (see SHARDED_TRAIN): NCCL with one rank, a (1, 1)
    mesh, qwen2-0.5b's train, prefill and decode and its vocab shards,
    mamba2-130m's train, the meshed launcher. The group is destroyed
    however the phase ends."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_bundle
    from repro_torch.utils import tree_map
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        res = {}
        for arch in SHARDED_TRAIN:
            cfg = get_config(arch)
            host = get_bundle(cfg).init(torch.Generator().manual_seed(0))
            params = tree_map(lambda t: t.cuda(), _conditioned(host, cfg))
            del host
            r = {"phase": "sharded", "ok": True, "model": arch,
                 "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                          "backend": "nccl"},
                 "train": _sharded_train(arch, mesh, params)}
            if arch == "qwen2-0.5b":
                r["train_adafactor"] = _sharded_train(
                    arch, mesh, params, optimizer="adafactor",
                    steps=SHARDED_ADAFACTOR_STEPS)
                r["serve"] = _sharded_serve(arch, mesh, params)
                r["vocab_shards"] = _vocab_shards(arch, params)
            del params
            torch.cuda.empty_cache()
            emit(r)
            res[arch] = r
        r = {"phase": "sharded", "ok": True, "model": "qwen2-0.5b",
             "launcher": _sharded_launcher(train_res)}
        emit(r)
        res["launcher"] = r
        r = {"phase": "sharded", "ok": True, "model": MOE_ARCH,
             "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                      "backend": "nccl"},
             "expert_parallel": _sharded_moe(mesh)}
        emit(r)
        res[MOE_ARCH] = r
    finally:
        dist.destroy_process_group()
    return res


def _counting_backend(engines):
    """A TorchBackend over ``engines`` that counts the INFERs it runs, per
    model (``.infers``)."""
    from repro_torch.serving.engine import TorchBackend

    class CountingBackend(TorchBackend):
        def __init__(self, models):
            super().__init__(models)
            self.infers = dict.fromkeys(models, 0)

        def exec_duration(self, model, action):
            self.infers[model.model_id] += 1
            return super().exec_duration(model, action)

    return CountingBackend(engines)


def _serve(arch, model_id, n_req, sweep_reps, profiled, need_ok):
    """One full-width LM decode model (make_lm_decode_model, random weights
    drawn on the host from seed 0) served by a Clockwork Controller and one
    Worker over TorchBackend on a RealClock: ``n_req`` requests GAP_S
    apart, of which the share ``need_ok`` must be ``ok``, each INFER
    launching flash_decode once per attention layer; then a sweep of
    ``sweep_reps`` INFERs per bucket and one profiled INFER per bucket in
    ``profiled``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.actions import Request
    from repro_torch.core.clock import EventLoop, RealClock
    from repro_torch.core.controller import Controller
    from repro_torch.core.scheduler import ClockworkScheduler
    from repro_torch.core.worker import Worker
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serving.engine import make_lm_decode_model

    t0 = time.perf_counter()
    jm = make_lm_decode_model(model_id, arch=arch, full=True, batches=BUCKETS,
                              ctx=CTX, seed=0)
    t_init = time.perf_counter() - t0
    cfg = get_config(arch)
    n_layers = _attn_layers(cfg)
    load_s = jm.load()
    t0 = time.perf_counter()
    jm.compile()
    t_compile = time.perf_counter() - t0
    with torch.inference_mode():
        for b in jm.batches:
            _check_logits(jm.forward(jm.device_params, jm.make_input(b)), cfg, b)
    models = {model_id: jm.modeldef()}           # measured INFER profiles
    profiles = jm.seed_profiles()
    backend = _counting_backend({model_id: jm})
    loop = EventLoop(RealClock())
    worker = Worker("w0", loop, backend, models, n_gpus=1)
    controller = Controller(loop, models, ClockworkScheduler(),
                            action_delay=1e-4)
    controller.add_worker(worker, profiles=profiles)
    done = []
    controller.on_response = done.append

    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode.launches = 0                 # the main path's run starts
    backend.infers[model_id] = 0
    for _ in range(n_req):
        controller.on_request(Request(model_id=model_id, arrival=loop.now(),
                                      slo=SLO_S))
        loop.run_until(loop.now() + GAP_S)
    loop.run_until(loop.now() + 3.0)
    launches = fd.flash_decode.launches          # ... and ends
    infers = backend.infers[model_id]

    ok = [r for r in done if r.status == "ok"]
    lat = [(r.completion - r.arrival) for r in ok]
    res = {"phase": "serve", "model": arch, "layers": cfg.num_layers,
           "attention_layers": n_layers,
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
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    res["ok"] = (len(ok) >= need_ok * n_req and infers > 0
                 and launches == n_layers * infers)
    # a dedicated sweep for the spread of execution time per bucket (Fig. 2)
    sweep = jm.measure(reps=sweep_reps)
    res["sweep_by_bucket"] = {str(b): _spread(d) for (_, b), d in sweep.items()}
    res["profiled_infers"] = [_profile_infer(jm, b) for b in profiled]
    # one flash_decode device kernel per attention layer and INFER: a
    # single launch
    res["flash_decode_device_kernels_per_infer"] = [
        p["port_kernels"]["flash_decode"] for p in res["profiled_infers"]]
    res["ok"] = res["ok"] and all(
        n == n_layers for n in res["flash_decode_device_kernels_per_infer"])
    if not res["ok"]:
        emit(res)
        die("serve", f"{arch}: {len(ok)}/{n_req} ok, {launches} launches "
                     f"for {infers} INFERs ({n_layers} per INFER expected), "
                     f"flash_decode device kernels per profiled INFER "
                     f"{res['flash_decode_device_kernels_per_infer']} "
                     f"({n_layers} expected)")
    jm.unload()
    return res


def phase_serve():
    """qwen2-0.5b (30 requests, at least 90% ok, as
    tests/test_system.py's round trip) and the RG-LRU hybrid (every
    request ok), each alone on the Worker."""
    smoke = _check_against_cpu()
    qwen2 = _serve("qwen2-0.5b", "qwen2_decode", N_REQUESTS, SWEEP_REPS,
                   (1, 8), 0.9)
    emit({**qwen2, "smoke_card_vs_cpu": smoke})
    rg = _serve(RG_ARCH, "recurrentgemma_decode", RG_REQUESTS, RG_SWEEP, (1,),
                1.0)
    emit(rg)
    return {"qwen2-0.5b": qwen2, RG_ARCH: rg}


def _attn_layers(cfg):
    """The attention layers of a config (each launches flash_decode once per
    decode step)."""
    pattern, n_groups, leftover = cfg.pattern_split()
    return sum(k in ("attn", "local") for k in pattern * n_groups + leftover)


def _resnet_flops(params, img):
    """FLOP per image of resnet50_forward: 2 per multiply-add of every conv
    at its output size (XLA's "SAME": ceil(n / stride)) and of the head."""
    from repro_torch.models.resnet import STAGES

    def conv(w, n):
        o, i, kh, kw = w.shape
        return 2 * o * i * kh * kw * n * n

    n = -(-img // 2)
    flops = conv(params["stem"], n)
    n = -(-n // 2)                                   # the max-pool
    for si in range(len(STAGES)):
        for bi, bp in enumerate(params[f"stage{si}"]):
            m = -(-n // (2 if (bi == 0 and si > 0) else 1))
            flops += (conv(bp["conv1"], n) + conv(bp["conv2"], m)
                      + conv(bp["conv3"], m)
                      + (conv(bp["proj"], m) if "proj" in bp else 0))
            n = m
    return flops + 2 * params["head"].numel()


def _resnet_against_cpu(jm):
    """The card's bf16 logits at batch 2 against the port's CPU path on the
    same input: within 2e-2 x max(|ref|, 1) of the CPU's f32 run (the bf16
    weights cast to f32), plus twice the CPU's own bf16-vs-f32 error, as
    ROADMAP.md section 3 holds gemma2; and finite."""
    import torch
    from repro_torch.utils import tree_map
    x = jm.make_input(2)
    t0 = time.perf_counter()
    with torch.inference_mode():
        card = jm.forward(jm.device_params, x).float().cpu()
        cpu16 = jm.forward(jm.host_params, x.cpu()).float()
        cpu32 = jm.forward(tree_map(lambda t: t.float(), jm.host_params),
                           x.cpu())
    if card.shape != (2, 256) or not torch.isfinite(card).all().item():
        die("resnet", f"card logits {tuple(card.shape)} not (2, 256) or "
                      f"not finite")
    err = (card - cpu32).abs().max().item()
    cpu_err = (cpu16 - cpu32).abs().max().item()
    bound = 2e-2 * max(cpu32.abs().max().item(), 1.0) + 2 * cpu_err
    if not err <= bound:
        die("resnet", f"card vs CPU logits at batch 2: {err} > {bound}")
    return {"max_abs_err": err, "bound": bound, "cpu_bf16_vs_f32": cpu_err,
            "ref_max_abs": cpu32.abs().max().item(),
            "seconds": time.perf_counter() - t0}


def _infer_clocks(jm, b):
    """One INFER of bucket ``b`` timed as TorchModel.run times it (the host
    clock from a synchronised card to a synchronised card, the input made
    before), with CUDA events recorded around the same forward: (host ms,
    event ms)."""
    import torch
    x = jm.make_input(b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    with torch.inference_mode():
        jm.forward(jm.device_params, x)
    end.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def _graph_infer_ms(jm, b, n):
    """Event ms of ``n`` replays, one at a time, of bucket ``b``'s forward
    captured once in a CUDA graph: the card's time for the INFER with no
    host dispatch between its kernels."""
    import torch
    x = jm.make_input(b)
    with torch.inference_mode():
        graph = _capture(lambda: jm.forward(jm.device_params, x))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def _fig2(ms):
    """The paper's Fig. 2 spread: the median and each tail over it."""
    import numpy as np
    a = np.asarray(ms, dtype=np.float64)
    med = float(np.median(a))
    return {"n": int(a.size), "median_ms": med,
            "p99_over_median": float(np.percentile(a, 99)) / med,
            "p99.9_over_median": float(np.percentile(a, 99.9)) / med,
            "max_over_median": float(a.max()) / med,
            "cv": float(a.std() / a.mean())}


def _conv_weights(params):
    from repro_torch.utils import tree_leaves
    return [t for t in tree_leaves(params) if t.dim() == 4]


def phase_resnet():
    """Full-width ResNet-50 through the engine: card vs CPU, then per bucket
    INFER times on both clocks, a profile, the bound, LOAD and peak bytes,
    then Fig. 2 on the card."""
    import gc
    import numpy as np
    import torch
    from repro_torch.serving.engine import make_resnet_model
    gc.collect()                            # earlier phases' engines
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    jm = make_resnet_model("resnet50", scale=1, img=RESNET_IMG,
                           batches=RESNET_BUCKETS, seed=0)
    t_init = time.perf_counter() - t0
    if not all(t.is_contiguous(memory_format=torch.channels_last)
               for t in _conv_weights(jm.host_params)):
        die("resnet", "a conv weight is not channels_last in host memory")
    load_ms = [s * 1e3 for s in jm.measure_load(reps=5)]
    if not all(t.is_contiguous(memory_format=torch.channels_last)
               for t in _conv_weights(jm.device_params)):
        die("resnet", "a conv weight is not channels_last on the card")
    jm.compile()
    cpu_check = _resnet_against_cpu(jm)
    flops = _resnet_flops(jm.host_params, RESNET_IMG)

    _zero_counts()                          # the ResNet path's run starts
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    buckets = {}
    for b in RESNET_BUCKETS:
        clocks = [_infer_clocks(jm, b) for _ in range(RESNET_REPS)]
        host, dev = zip(*clocks)
        bytes_moved = (jm.weights_bytes + b * 3 * RESNET_IMG ** 2 * 4
                       + b * 256 * 2)
        bound = _bound(bytes_moved, flops * b)
        buckets[str(b)] = {
            "host_p50_ms": float(np.median(host)),
            "event_p50_ms": float(np.median(dev)),
            **bound, "bound_share_of_event_p50": bound["bound_ms"]
            / float(np.median(dev)),
            "profile": _profile_infer(jm, b)}
    peak = torch.cuda.max_memory_allocated()
    launches = _read_counts()               # ... and ends: no port kernel
    fig2 = {}
    for b, n in FIG2_RUNS:
        host, dev = zip(*[_infer_clocks(jm, b) for _ in range(n)])
        fig2[str(b)] = {"host_clock": _fig2(host), "cuda_events": _fig2(dev),
                        "cuda_graph_replay": _fig2(_graph_infer_ms(jm, b, n))}
    res = {"phase": "resnet", "ok": True, "model": "resnet50",
           "img": RESNET_IMG, "classes": 256,
           "weights_bytes": jm.weights_bytes, "init_s": t_init,
           "load_ms": load_ms, "load_p50_ms": float(np.median(load_ms)),
           "gflop_per_image": flops / 1e9, "card_vs_cpu": cpu_check,
           "port_kernel_launches": launches, "peak_device_bytes": peak,
           "device_bytes_before_infers": start_bytes,
           "buckets": buckets, "fig2": fig2}
    emit(res)
    jm.unload()
    torch.cuda.empty_cache()
    return res


def phase_profile():
    """The offline profiler over both full-width models and its own
    default_specs(): a complete store, saved and reloaded, and Table 1."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serving.engine import make_lm_decode_model, make_resnet_model
    from repro_torch.telemetry.profile_store import ProfileStore
    from repro_torch.telemetry.profiler import build_store, default_specs
    from repro_torch.telemetry.reports import profile_table
    specs = [("resnet50", lambda: make_resnet_model(
                 "resnet50", scale=1, img=RESNET_IMG, batches=RESNET_BUCKETS)),
             ("qwen2_full_decode", lambda: make_lm_decode_model(
                 "qwen2_full_decode", full=True, batches=BUCKETS, ctx=CTX))]
    specs += default_specs()
    buckets = {}                            # model id -> its engine's buckets

    def noting(mk):
        def make():
            jm = mk()
            buckets[jm.model_id] = jm.batches
            return jm
        return make

    specs = [(name, noting(mk)) for name, mk in specs]
    _zero_counts()                          # the profiler's run starts
    t0 = time.perf_counter()
    store = build_store(specs, reps=PROFILE_REPS)
    secs = time.perf_counter() - t0
    launches = _read_counts()               # ... and ends
    lm_cfgs = {"qwen2_full_decode": get_config("qwen2-0.5b"),
               "qwen2_decode": get_smoke_config("qwen2-0.5b"),
               "mamba2_decode": get_smoke_config("mamba2-130m")}
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 0,
            "ssd_scan_bwd": 0, "flash_decode": sum(
        (PROFILE_REPS + 1) * len(buckets[mid]) * _attn_layers(cfg)
        for mid, cfg in lm_cfgs.items())}
    if launches != want:
        die("profile", f"launches {launches}, expected {want}")
    path = ROOT / "build" / "chip_smoke_profiles.json"
    store.save(str(path))
    loaded = ProfileStore.load(str(path))
    want_keys = {("INFER", mid, b) for mid, bs in buckets.items() for b in bs}
    want_keys |= {("LOAD", mid, 1) for mid in buckets}
    keys = {k for k, _ in loaded.items()}
    if keys != want_keys or len(buckets) != len(specs):
        die("profile", f"store keys {sorted(keys)} != {sorted(want_keys)}")
    res = {"phase": "profile", "ok": True, "models": list(buckets),
           "entries": len(loaded), "seconds": secs, "reps": PROFILE_REPS,
           "launches": launches, "store": str(path.relative_to(ROOT)),
           "table1": profile_table(loaded, batches=RESNET_BUCKETS)}
    emit(res)
    return path


def phase_runtime(store_path):
    """Both full-width models served over the copied runtime's wire
    protocol, seeded from the profile phase's store."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.clock import EventLoop, RealClock
    from repro_torch.core.controller import Controller
    from repro_torch.core.scheduler import ClockworkScheduler
    from repro_torch.core.worker import Worker
    from repro_torch.runtime.client import RemoteClient
    from repro_torch.runtime.controller import ControllerServer
    from repro_torch.runtime.transport import LoopbackLink
    from repro_torch.runtime.worker import WorkerHost
    from repro_torch.serving.engine import (make_lm_decode_model,
                                            make_resnet_model, seed_engines,
                                            update_store)
    from repro_torch.serving.workload import build_workload
    from repro_torch.telemetry.profile_store import ProfileStore

    gc.collect()                            # earlier phases' engines
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engines = {
        "resnet50": make_resnet_model("resnet50", scale=1, img=RESNET_IMG,
                                      batches=RESNET_BUCKETS),
        "qwen2_full_decode": make_lm_decode_model(
            "qwen2_full_decode", full=True, batches=BUCKETS, ctx=CTX)}
    store = ProfileStore.load(str(store_path))
    profiles = seed_engines(engines, store)
    for e in engines.values():
        e.compile()                         # untimed: builds, not measures
    models = {mid: e.modeldef() for mid, e in engines.items()}

    loop = EventLoop(RealClock())
    controller = Controller(loop, models, ClockworkScheduler(),
                            action_delay=1e-4)
    server = ControllerServer(controller)
    worker_link, client_link = LoopbackLink(loop), LoopbackLink(loop)
    server.adopt(worker_link.a)
    backend = _counting_backend(engines)
    host = WorkerHost(Worker("w0", loop, backend, models, n_gpus=1),
                      worker_link.b, profiles=profiles)
    host.register()
    server.adopt(client_link.a)
    client = RemoteClient(loop, client_link.b)
    if not (host.registered and "w0" in controller.workers):
        die("runtime", "the worker did not register over the loopback link")

    _zero_counts()                          # the runtime's run starts
    client.attach(build_workload(
        loop, client.submit, list(engines), kind="open", slo=SLO_S,
        rate=RUNTIME_RATE, start=loop.now(), duration=RUNTIME_S, seed=0))
    loop.run_until(loop.now() + RUNTIME_S + 3.0)
    launches = _read_counts()               # ... and ends
    summary = client.summary()

    fresh = {mid: e.fresh_profiles() for mid, e in engines.items()}
    recorded = {}
    for a in controller.recorder.iter_actions():
        if a.status == "SUCCESS" and a.actual > 0:
            key = (a.action_type, a.model_id, a.batch_size)
            recorded[key] = recorded.get(key, 0) + 1
    before = {k: p.count for k, p in store.items()}
    update_store(engines, store, controller)
    folded_only_fresh = all(
        p.count == before.get(k, 0) + recorded.get(k, 0)
        for k, p in store.items()) and not any(fresh.values())
    host.shutdown()
    loop.run_until(loop.now() + 0.2)

    per_model = {}
    for mid in engines:
        lat = [r.completion - r.arrival for r in controller.completed
               if r.model_id == mid and r.status == "ok"]
        per_model[mid] = {
            "ok": len(lat), "infer_actions": backend.infers[mid],
            "latency_p50_ms": float(np.median(lat)) * 1e3 if lat else None,
            "latency_max_ms": max(lat) * 1e3 if lat else None,
            "learned_infer_ms": {
                str(b): controller.profiler.estimate("INFER", mid, b) * 1e3
                for b in engines[mid].batches},
            "warmup_count": engines[mid].warmup_count}
    q_infers = backend.infers["qwen2_full_decode"]
    n_layers = _attn_layers(get_config("qwen2-0.5b"))
    res = {"phase": "runtime", "client": summary, "models": per_model,
           "launches": launches, "frames_dropped": sum(
               l.dropped for l in (worker_link, client_link)),
           "flash_decode_launches_per_qwen2_infer":
               launches["flash_decode"] / q_infers if q_infers else None,
           "update_store_folded_only_fresh": folded_only_fresh,
           "worker_closed": host.closed,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    res["ok"] = (summary["sent"] > 0
                 and summary["goodput"] >= 0.9 * summary["sent"]
                 and all(m["warmup_count"] == 0 for m in per_model.values())
                 and q_infers > 0
                 and launches == {"flash_attention": 0,
                                  "flash_attention_bwd": 0, "ssd_scan": 0,
                                  "ssd_scan_bwd": 0,
                                  "flash_decode": n_layers * q_infers}
                 and folded_only_fresh and host.closed)
    emit(res)
    if not res["ok"]:
        die("runtime", f"{summary['goodput']}/{summary['sent']} ok, warmup "
                       f"counts {[m['warmup_count'] for m in per_model.values()]}"
                       f", launches {launches} for {q_infers} qwen2 INFERs "
                       f"({n_layers} each), update_store folded only fresh "
                       f"samples: {folded_only_fresh}, worker closed: "
                       f"{host.closed}")
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
    prefill = phase_prefill()
    train = phase_train()
    sharded = phase_sharded(train)
    serve = phase_serve()
    phase_resnet()
    runtime = phase_runtime(phase_profile())
    # launches of each kernel on every path, each path's counts read from
    # zero just before it and just after
    by_path = {name: {} for name in _counters()}
    for arch, r in prefill.items():
        for name, n in r.get("launches", {}).items():
            if n:
                by_path[name][f"prefill {arch}"] = n
    for arch, r in train.items():
        for name, n in r["launches"].items():
            if n:
                by_path[name][f"train {arch}"] = n
    for r in sharded.values():
        for part in ("train", "serve", "launcher", "expert_parallel"):
            for name, n in r.get(part, {}).get("launches", {}).items():
                if n:
                    by_path[name][f"sharded {r['model']} {part}"] = n
    for arch, r in serve.items():
        by_path["flash_decode"][f"serve {arch}"] = r["flash_decode_launches"]
    by_path["flash_decode"]["runtime"] = runtime["launches"]["flash_decode"]
    # the decode kernel's times at the shape its first path (serving
    # qwen2-0.5b) launched it at most: its most served bucket, the
    # engine's ctx
    served = serve["qwen2-0.5b"]["exec_by_bucket"]
    main_b = max(served, key=lambda b: served[b]["n"])
    fd_shape = next(s for s in kern["flash_decode"]["shapes"]
                    if (s["B"], s["S"]) == (int(main_b), CTX))
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "eager_ms", "plain_eager_ms", "library_eager_ms")
    fd = kern["flash_decode"]
    lines = [{
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:67",
        "launches": sum(by_path["flash_decode"].values()),
        "launches_by_path": by_path["flash_decode"],
        "launches_per_infer": {a: r["launches_per_infer"]
                               for a, r in serve.items()},
        "max_abs_err": max(fd["max_abs_err_serving"], fd["max_abs_err_path"]),
        **{k: fd_shape[k] for k in timed},
        "shape": {k: fd_shape[k] for k in ("B", "S", "cur", "K", "G", "D",
                                           "dtype")}}]
    # the prefill kernels' times at their first path's first shape
    for name, arch, src, replaces, keys in (
            ("flash_attention", "qwen2-0.5b", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:83",
             ("B", "S", "H", "K", "D", "causal", "dtype")),
            ("ssd_scan", "mamba2-130m", "ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:72",
             ("B", "L", "H", "P", "N", "chunk", "dtype"))):
        shape = kern[name]["shapes"][0]
        lines.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "launches_per_prefill": {
                a: r["launches_per_prefill"][name] for a, r in prefill.items()
                if r.get("launches_per_prefill", {}).get(name)},
            **({"launches_per_train_step": {
                a: r["launches_per_step"][name] for a, r in train.items()
                if r["launches_per_step"][name]}}
               if any(r["launches_per_step"][name] for r in train.values())
               else {}),
            "max_abs_err": kern[name]["max_abs_err_path"],
            **{k: shape[k] for k in timed},
            **({"library_note": shape["library_note"]}
               if "library_note" in shape else {}),
            "shape": {k: shape[k] for k in keys}})
    bwd = kern["flash_attention_bwd"]
    shape = bwd["shapes"][0]
    lines.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/flash_xla.py:105",
        "launches": sum(by_path["flash_attention_bwd"].values()),
        "launches_by_path": by_path["flash_attention_bwd"],
        "launches_per_train_step": train["qwen2-0.5b"]["launches_per_step"][
            "flash_attention_bwd"],
        "max_abs_err": bwd["max_abs_err_path"],
        "max_rel_err": bwd["max_rel_err_path"],
        **{k: shape[k] for k in timed},
        "library_note": shape["library_note"],
        "shape": {k: shape[k] for k in ("B", "S", "H", "K", "D", "causal",
                                        "dtype")}})
    # the SSD backward's times at its train path's own microbatch (4, 1024)
    sbwd = kern["ssd_scan_bwd"]
    shape = sbwd["shapes"][0]
    lines.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:72",
        "launches": sum(by_path["ssd_scan_bwd"].values()),
        "launches_by_path": by_path["ssd_scan_bwd"],
        "launches_per_train_step": train["mamba2-130m"]["launches_per_step"][
            "ssd_scan_bwd"],
        "max_abs_err": sbwd["max_abs_err_path"],
        "max_rel_err": sbwd["max_rel_err_path"],
        **{k: shape[k] for k in timed},
        "library_note": shape["library_note"],
        "shape": {k: shape[k] for k in ("B", "L", "H", "P", "N", "chunk",
                                        "dtype")}})
    variant = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for line, key in zip(lines[:4], ("lse", "k0", None, "k0")):
        if key is not None:           # the k0 and lse variants' rows
            v = kern[line["name"]][key]
            line[f"{key}_variant"] = {
                **{k: v[k] for k in variant},
                **{k: v[k] for k in ("S", "segments", "shards", "k0",
                                     "all_segments_ms", "whole_call_ms",
                                     "without_lse_ms") if k in v}}
    emit({"kernels": lines})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
