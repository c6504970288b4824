"""Training launcher (port of ``repro.launch.train``): the train loop with
checkpoint/restart and the resumable, prefetched data pipeline, on one
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 256 --device cpu

``--smoke`` (the default) uses the reduced config; ``--full`` the published
one (qwen2-0.5b at full width runs on one H100). ``--device`` is ``cuda``
unless the CPU is asked for. The reference lays the step out on a mesh;
here it runs on one device (the mesh comes with the multi-device port), and
the microbatch count is the reference's rule with a data-parallel width of
one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed.steps import make_train_step
from repro_torch.models.registry import get_bundle
from repro_torch.training.optimizer import get_optimizer
from repro_torch.utils import resolve_device, tree_map


def microbatch_count(cfg, batch: int) -> int:
    """The largest count <= cfg.microbatches that divides the batch (the
    reference's ``build_sharded_step`` rule, one data-parallel rank)."""
    n = max(1, min(cfg.microbatches, batch))
    while n > 1 and batch % n:
        n -= 1
    return n


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 256,
          smoke: bool = True, ckpt_dir: str = None, ckpt_every: int = 25,
          log_every: int = 10, microbatches=None, seed: int = 0,
          device="cuda"):
    """Train from scratch, or from the newest checkpoint in ``ckpt_dir``, up
    to ``steps``; returns the loss of every step run. The weights are drawn
    on the host from ``seed`` (so every device starts from the same ones);
    step i trains on the data pipeline's batch i, whatever step the run
    started at."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if microbatches is not None:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    shape = ShapeSpec("custom_train", "train", seq, batch)
    bundle = get_bundle(cfg)
    spec = bundle.spec()
    opt = get_optimizer(cfg.optimizer)
    step_fn = make_train_step(cfg, opt,
                              microbatches=microbatch_count(cfg, batch),
                              device=dev)

    start = 0
    if ckpt_dir and (ls := latest_step(ckpt_dir)) is not None:
        start = ls
        params = restore_checkpoint(ckpt_dir, ls, spec, device=dev)
        opt_state = restore_checkpoint(ckpt_dir + "/opt", ls, opt.spec(spec),
                                       device=dev)
        print(f"[train] restored step {ls} from {ckpt_dir}")
    else:
        params = tree_map(lambda t: t.to(dev),
                          bundle.init(torch.Generator().manual_seed(seed)))
        opt_state = opt.init(params)

    source = SyntheticLM(cfg, shape, seed=seed)
    prefetch = Prefetcher(source, start_step=start)
    losses, writes = [], []
    t0 = time.time()
    try:
        for i in range(start, steps):
            step_id, host_batch = next(prefetch)
            if step_id != i:
                raise RuntimeError(f"data pipeline at step {step_id}, "
                                   f"train loop at {i}")
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 host_batch, i)
            loss = float(metrics["loss"])
            losses.append(loss)
            if i % log_every == 0 or i == steps - 1:
                print(f"[train] step {i:5d} loss {loss:.4f} "
                      f"({(time.time()-t0):.1f}s)", flush=True)
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                writes.append(save_checkpoint(ckpt_dir, i + 1, params,
                                              wait=False))
                save_checkpoint(ckpt_dir + "/opt", i + 1, opt_state,
                                wait=True)
    finally:
        prefetch.close()
        for w in writes:            # no write outlives the run
            w.join()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_NAMES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    losses = train(args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, smoke=args.smoke, ckpt_dir=args.ckpt,
                   device=args.device)
    print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
