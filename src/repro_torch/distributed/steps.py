"""Plain train, prefill and decode steps (port of the single-device
builders in ``repro.distributed.steps``): the entry points of the training
and prefill → decode paths. The mesh-sharded builder
(``build_sharded_step``) comes with the multi-device port.

Each builder resolves its device once: CUDA by default, never swapped for
the CPU (``device="cuda"`` without a card raises). A step moves its inputs
there; the caller's parameters, optimizer state and cache must already
live on that device. Prefill and decode run under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import greedy_sample
from repro_torch.models.registry import get_bundle
from repro_torch.training.optimizer import clip_by_global_norm
from repro_torch.utils import (resolve_device, tree_leaves, tree_map,
                               tree_unflatten)


def cross_entropy(cfg: ModelConfig, logits, targets):
    """Mean next-token loss, the log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return -ll.mean()


def _to_device(batch, dev):
    """A batch of numpy arrays or tensors as tensors on ``dev``."""
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt, microbatches: Optional[int] = None,
                    device="cuda"):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm", "step"}), with optional gradient accumulation over
    ``microbatches`` (default ``cfg.microbatches``) as the reference's:
    loss and grads per microbatch, the grads summed in the parameter dtype
    and divided by n in f32, then ``clip_by_global_norm(grads, 1.0)`` and
    ``opt.update``. The returned trees are new; the arguments are left as
    they were. ``batch`` holds ``tokens`` and ``targets`` (B, S) and, by
    family, ``frames`` or ``image_embeds``; numpy arrays are taken."""
    bundle = get_bundle(cfg)
    dev = resolve_device(device)

    def loss_and_grads(params, mb):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            logits = bundle.train_logits(tree_unflatten(params, leaves), mb)
            loss = cross_entropy(cfg, logits, mb["targets"])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(params, grads)

    def finish(params, opt_state, loss, grads, step):
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = opt.update(grads, opt_state, params, step)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     "step": step + 1}

    def train_step(params, opt_state, batch, step):
        batch = _to_device(batch, dev)
        n = microbatches if microbatches is not None else cfg.microbatches
        b0 = next(iter(batch.values())).shape[0]
        if n <= 1 or b0 % n != 0:
            loss, grads = loss_and_grads(params, batch)
            return finish(params, opt_state, loss, grads, step)
        m = b0 // n
        # accumulate in the parameter dtype, as the reference does (an f32
        # accumulator would double the parameter footprint)
        gsum = tree_map(torch.zeros_like, params)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, grads = loss_and_grads(params, mb)
            gsum = tree_unflatten(params, [
                a + g.to(a.dtype) for a, g in zip(tree_leaves(gsum),
                                                  tree_leaves(grads))])
            lsum = lsum + loss
        grads = tree_unflatten(params, [
            (g.float() / n).to(p.dtype) for g, p in zip(tree_leaves(gsum),
                                                       tree_leaves(params))])
        return finish(params, opt_state, lsum / n, grads, step)

    return train_step


INPUTS = ("tokens", "frames", "image_embeds")


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None,
                      device="cuda"):
    """prefill_step(params, {"tokens": (B, S)} with, for an encoder-decoder
    model, "frames" (B, Se, d) and, for a VLM, "image_embeds" (B, P, d)) ->
    (next tokens (B, 1) int32, decode-ready cache of ``cache_len`` slots,
    default the prefilled length: S, or P + S for a VLM)."""
    bundle = get_bundle(cfg)
    dev = resolve_device(device)

    def prefill_step(params, batch):
        inputs = {k: batch[k].to(dev) for k in INPUTS if k in batch}
        with torch.no_grad():
            logits, cache = bundle.prefill(params, inputs,
                                           cache_len=cache_len)
        return greedy_sample(logits), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """decode_step(params, cache, tokens (B, 1), cur_index) -> (next tokens
    (B, 1) int32, cache). The cache is updated in place and returned."""
    bundle = get_bundle(cfg)
    dev = resolve_device(device)

    def decode_step(params, cache, tokens, cur_index):
        with torch.no_grad():
            logits, cache = bundle.decode(params, cache, tokens.to(dev),
                                          cur_index)
        return greedy_sample(logits), cache

    return decode_step
