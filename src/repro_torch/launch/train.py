"""Training launcher (port of ``repro.launch.train``): the train loop with
checkpoint/restart and the resumable, prefetched data pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 256 --device cpu

``--smoke`` (the default) uses the reduced config; ``--full`` the published
one (qwen2-0.5b at full width runs on one H100). ``--device`` is ``cuda``
unless the CPU is asked for.

Under an initialised process group (``torchrun``: ``main`` initialises one
from the environment, NCCL on CUDA, gloo on the CPU) the step runs on a
("data", "model") mesh, ``mesh_shape`` or (world size, 1), through
``build_sharded_step``, as the reference does. Without one, it runs on one
device with the reference's microbatch rule for a data-parallel width of
one. Checkpoints are the reference's on-disk format: under a mesh rank 0
writes the gathered tensors, and a restore is laid out on the mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed.sharding import distribute
from repro_torch.distributed.steps import (build_sharded_step,
                                           make_train_step, microbatches_for)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_bundle
from repro_torch.training.optimizer import get_optimizer
from repro_torch.utils import resolve_device, tree_map


def _full(tree):
    """A tree of DTensors as whole tensors (a collective: every rank)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 256,
          smoke: bool = True, ckpt_dir: str = None, ckpt_every: int = 25,
          mesh_shape=None, log_every: int = 10, microbatches=None,
          seed: int = 0, device="cuda"):
    """Train from scratch, or from the newest checkpoint in ``ckpt_dir``, up
    to ``steps``; returns the loss of every step run. The weights are drawn
    on the host from ``seed`` (so every device starts from the same ones);
    step i trains on the data pipeline's batch i, whatever step the run
    started at. ``mesh_shape`` needs an initialised process group."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if microbatches is not None:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    shape = ShapeSpec("custom_train", "train", seq, batch)
    bundle = get_bundle(cfg)
    spec = bundle.spec()
    opt = get_optimizer(cfg.optimizer)
    meshed = dist.is_initialized()
    if mesh_shape is not None and not meshed:
        raise ValueError("mesh_shape needs an initialised process group")
    if meshed:
        mesh = make_mesh(mesh_shape or (dist.get_world_size(), 1),
                         ("data", "model"), device_type=dev.type)
        sharded = build_sharded_step(cfg, mesh, shape, chunk=min(1024, seq))
        step_fn = sharded.fn
        place = lambda tree, sh: distribute(tree, sh, mesh)  # noqa: E731
        param_sh, opt_sh = sharded.in_shardings[:2]
    else:
        step_fn = make_train_step(
            cfg, opt, microbatches=microbatches_for(cfg, batch, 1),
            device=dev)
        place = lambda tree, sh: tree  # noqa: E731
        param_sh = opt_sh = None
    writer = not meshed or dist.get_rank() == 0

    start = 0
    if ckpt_dir and (ls := latest_step(ckpt_dir)) is not None:
        start = ls
        params = place(restore_checkpoint(ckpt_dir, ls, spec, device=dev),
                       param_sh)
        opt_state = place(restore_checkpoint(ckpt_dir + "/opt", ls,
                                             opt.spec(spec), device=dev),
                          opt_sh)
        print(f"[train] restored step {ls} from {ckpt_dir}")
    else:
        params = tree_map(lambda t: t.to(dev),
                          bundle.init(torch.Generator().manual_seed(seed)))
        params = place(params, param_sh)
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
            loss = float(_full(metrics["loss"]))
            losses.append(loss)
            if i % log_every == 0 or i == steps - 1:
                print(f"[train] step {i:5d} loss {loss:.4f} "
                      f"({(time.time()-t0):.1f}s)", flush=True)
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                p_full, o_full = _full(params), _full(opt_state)
                if writer:
                    writes.append(save_checkpoint(ckpt_dir, i + 1, p_full,
                                                  wait=False))
                    save_checkpoint(ckpt_dir + "/opt", i + 1, o_full,
                                    wait=True)
                if meshed:          # no rank reads a step before it exists
                    for w in writes:
                        w.join()
                    dist.barrier()
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
    if "WORLD_SIZE" in os.environ:          # launched by torchrun
        if args.device.startswith("cuda"):
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if args.device.startswith("cuda")
                                else "gloo")
    try:
        losses = train(args.arch, steps=args.steps, batch=args.batch,
                       seq=args.seq, smoke=args.smoke, ckpt_dir=args.ckpt,
                       device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
