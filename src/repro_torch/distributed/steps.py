"""Step builders: train / prefill / decode, plain and mesh-sharded (port
of ``repro.distributed.steps``).

Each plain builder resolves its device once: CUDA by default, never
swapped for the CPU (``device="cuda"`` without a card raises). A step moves
its inputs there; the caller's parameters, optimizer state and cache must
already live on that device. Prefill and decode run under
``torch.no_grad()``.

``build_sharded_step`` runs the same plain steps on a ``DeviceMesh``, on
DTensors laid out by the logical-axis rules (``distributed.sharding``): it
is what the dry run and the meshed trainer run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.configs.shapes import (batch_logical_axes, decode_cache_len,
                                        inputs_for)
from repro_torch.distributed import vocab
from repro_torch.distributed.sharding import (axis_sizes, backward_under_rules,
                                              current_mesh_rules,
                                              current_placements, distribute,
                                              make_rules, replicated,
                                              shardings_for,
                                              shardings_from_axes, use_rules)
from repro_torch.models import params as pspec
from repro_torch.models.lm import greedy_sample
from repro_torch.models.registry import get_bundle
from repro_torch.training.optimizer import clip_by_global_norm, get_optimizer
from repro_torch.utils import resolve_device, tree_leaves, tree_unflatten


def _token_ll(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets[..., None].long())[..., 0]


def cross_entropy(cfg: ModelConfig, logits, targets):
    """Mean next-token loss, the log-softmax in f32. Under a mesh whose
    model axis splits the vocab, each rank keeps its vocab shard of the
    logits and the ranks merge their rows' max, sum and target logit
    (``distributed/vocab.py``); with the vocab whole on every rank, each
    takes its own rows' terms (``local_map``)."""
    if not isinstance(logits, DTensor):
        return -_token_ll(logits, targets).mean()
    if vocab.vocab_groups(logits, -1):
        return -vocab.token_ll(logits, targets).mean()
    mesh, _ = current_mesh_rules()
    rows = current_placements(targets.shape, "batch", "seq")
    whole = current_placements(logits.shape, "batch", "seq", None)
    ll = local_map(_token_ll, out_placements=list(rows),
                   in_placements=(whole, rows), device_mesh=mesh,
                   redistribute_inputs=True)(logits, targets)
    return -ll.mean()


def _to_device(batch, dev):
    """A batch of numpy arrays or tensors as tensors on ``dev``."""
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _microbatch(v, i: int, n: int):
    """Rows of microbatch ``i`` of ``n``. A DTensor batch sharded over its
    rows gives each rank the i-th of n slices of its own rows, so every
    microbatch stays spread over the data axes (the reference reshapes to
    (n, B/n) with the second dim sharded); the global rows of microbatch i
    then differ from the plain step's, not the sum over all of them."""
    if isinstance(v, DTensor) and any(p.is_shard(0) for p in v.placements):
        local = v.to_local()
        m = local.shape[0] // n
        return DTensor.from_local(local[i * m:(i + 1) * m], v.device_mesh,
                                  v.placements)
    m = v.shape[0] // n
    return v[i * m:(i + 1) * m]


def _zeros_as(g, dtype):
    """Zeros of ``g``'s shape in ``dtype``, a DTensor laid out as ``g``
    (``Partial`` too) where ``g`` is one."""
    if not isinstance(g, DTensor):
        return torch.zeros_like(g, dtype=dtype)
    return DTensor.from_local(torch.zeros_like(g.to_local(), dtype=dtype),
                              g.device_mesh, g.placements, run_check=False)


def reduce_to_params(grads, params):
    """Each gradient laid out as its parameter. Under a mesh, the gradient
    of a weight that the data axes replicate comes out of the backward as a
    ``Partial`` sum over them; it is reduced here once, in the parameter
    dtype (one all-reduce a leaf; a ``Partial`` over a dim that splits the
    parameter, as the experts' over the data axes, a reduce-scatter).
    Plain tensors, and DTensors already laid out so, pass as they are."""
    return tree_unflatten(params, [
        g.redistribute(p.device_mesh, p.placements)
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
            p.placements) else g
        for g, p in zip(tree_leaves(grads), tree_leaves(params))])


def make_train_step(cfg: ModelConfig, opt, microbatches: Optional[int] = None,
                    device="cuda"):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm", "step"}), with optional gradient accumulation over
    ``microbatches`` (default ``cfg.microbatches``) as the reference's:
    loss and grads per microbatch, the grads summed in the parameter dtype
    and divided by n in f32, then ``clip_by_global_norm(grads, 1.0)`` and
    ``opt.update``. Under a mesh, the microbatches' ``Partial`` gradients
    are summed as they are and reduced once, before the division
    (``reduce_to_params``), so the optimizer gets each gradient laid out as
    its parameter. The returned trees are new; the arguments are left as
    they were. ``batch`` holds ``tokens`` and ``targets`` (B, S) and, by
    family, ``frames`` or ``image_embeds``; numpy arrays are taken."""
    bundle = get_bundle(cfg)
    dev = resolve_device(device)

    def loss_and_grads(params, mb):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            logits = bundle.train_logits(tree_unflatten(params, leaves), mb)
            loss = cross_entropy(cfg, logits, mb["targets"])
            backward_under_rules(loss)
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
            return finish(params, opt_state, loss,
                          reduce_to_params(grads, params), step)
        # accumulate in the parameter dtype, as the reference does (an f32
        # accumulator would double the parameter footprint), from zeros laid
        # out as the gradients come (a Partial sum adds to a Partial one
        # with no collective)
        gsum = None
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n):
            mb = {k: _microbatch(v, i, n) for k, v in batch.items()}
            loss, grads = loss_and_grads(params, mb)
            if gsum is None:
                gsum = tree_unflatten(params, [
                    _zeros_as(g, p.dtype) for g, p in zip(
                        tree_leaves(grads), tree_leaves(params))])
            gsum = tree_unflatten(params, [
                a + g.to(a.dtype) for a, g in zip(tree_leaves(gsum),
                                                  tree_leaves(grads))])
            lsum = lsum + loss
            del grads       # not held through the next microbatch
        grads = tree_unflatten(params, [
            (g.float() / n).to(p.dtype) for g, p in zip(
                tree_leaves(reduce_to_params(gsum, params)),
                tree_leaves(params))])
        del gsum            # not held through the update
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


# --------------------------------------------------------- sharded builder

@dataclasses.dataclass
class ShardedStep:
    kind: str
    fn: Any                # the step on the mesh, (args) as ``abstract``
    abstract: tuple        # meta-tensor arguments matching fn's signature
    rules: dict
    mesh: Any
    in_shardings: tuple    # placements per argument leaf (None: not a tensor)


def _sds_i32():
    return torch.empty((), dtype=torch.int32, device="meta")


def microbatches_for(cfg: ModelConfig, global_batch: int, dp: int) -> int:
    """The largest count <= cfg.microbatches such that each microbatch still
    shards evenly over ``dp`` data-parallel ranks."""
    n_mb = max(1, min(cfg.microbatches, global_batch // max(dp, 1)))
    while n_mb > 1 and (global_batch % n_mb or (global_batch // n_mb) % dp):
        n_mb -= 1
    return n_mb


def build_sharded_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                       lr: float = 1e-3, chunk: int = 1024,
                       cache_len: Optional[int] = None) -> ShardedStep:
    """The train, prefill or decode step of ``shape.kind`` on ``mesh``.

    ``fn`` lays its arguments out by the rules (host arrays, plain tensors
    or DTensors), runs the plain step on DTensors under
    ``use_rules(mesh, rules)`` and returns DTensors laid out as the
    reference's ``out_shardings``: parameters and optimizer state as they
    came in, metrics replicated, tokens by ("batch", "seq"), the prefill's
    cache by the decode rules. It runs on the mesh's device type: the
    kernels on CUDA shards, their plain versions on CPU shards.
    ``cache_len`` sizes the prefill's cache (default the prefilled length);
    ``chunk`` is the reference's XLA attention chunk, which the port's
    kernels do not take."""
    del chunk
    rules = make_rules(mesh, cfg, shape.kind, shape)
    bundle = get_bundle(cfg)
    spec = bundle.spec()
    dev = mesh.device_type
    param_abs = pspec.abstract(spec)
    param_sh = shardings_for(spec, mesh, rules)
    batch_abs = inputs_for(cfg, shape)
    batch_sh = shardings_from_axes(batch_abs, batch_logical_axes(batch_abs),
                                   mesh, rules)
    rep = replicated(mesh)

    def run(inner, *args, cache_rules=None):
        with use_rules(mesh, rules, cache_rules):
            return inner(*args)

    if shape.kind == "train":
        opt = get_optimizer(cfg.optimizer, lr=lr)
        opt_spec = opt.spec(spec)
        opt_sh = shardings_for(opt_spec, mesh, rules)
        sizes = axis_sizes(mesh)
        dp = 1
        for a in rules.get("batch", ()):
            dp *= sizes.get(a, 1)
        inner = make_train_step(
            cfg, opt, microbatches=microbatches_for(cfg, shape.global_batch,
                                                    dp), device=dev)

        def fn(params, opt_state, batch, step):
            params = distribute(params, param_sh, mesh)
            opt_state = distribute(opt_state, opt_sh, mesh)
            batch = distribute(
                {k: batch[k] for k in batch_sh}, batch_sh, mesh)
            p, o, m = run(inner, params, opt_state, batch, int(step))
            metrics = {"loss": distribute(m["loss"], rep, mesh),
                       "grad_norm": distribute(m["grad_norm"], rep, mesh),
                       "step": m["step"]}
            return (distribute(p, param_sh, mesh),
                    distribute(o, opt_sh, mesh), metrics)

        return ShardedStep("train", fn, (param_abs, pspec.abstract(opt_spec),
                                         batch_abs, _sds_i32()),
                           rules, mesh, (param_sh, opt_sh, batch_sh, None))

    if shape.kind == "prefill":
        cross_len = shape.seq_len if cfg.is_encdec else 0
        cache_axes = bundle.cache_axes(cross_len)
        inner = make_prefill_step(cfg, cache_len=cache_len, device=dev)
        # The emitted cache is laid out for DECODE consumption (kv-replicated
        # archs get a seq-sharded cache, not a replicated one).
        dec_rules = make_rules(mesh, cfg, "decode", shape)

        def fn(params, batch):
            params = distribute(params, param_sh, mesh)
            batch = distribute({k: batch[k] for k in batch_sh}, batch_sh,
                               mesh)
            tok, cache = run(inner, params, batch, cache_rules=dec_rules)
            tok_sh = shardings_from_axes(tok, ("batch", "seq"), mesh, rules)
            cache_sh = shardings_from_axes(cache, cache_axes, mesh,
                                           dec_rules)
            return (distribute(tok, tok_sh, mesh),
                    distribute(cache, cache_sh, mesh))

        return ShardedStep("prefill", fn, (param_abs, batch_abs), rules,
                           mesh, (param_sh, batch_sh))

    # decode
    self_len, cross_len = decode_cache_len(cfg, shape)
    cache_abs = bundle.cache_abstract(shape.global_batch, self_len, cross_len)
    cache_axes = bundle.cache_axes(cross_len)
    cache_sh = shardings_from_axes(cache_abs, cache_axes, mesh, rules)
    tok_abs = batch_abs["tokens"]
    tok_sh = shardings_from_axes(tok_abs, ("batch", "seq"), mesh, rules)
    inner = make_decode_step(cfg, device=dev)

    def fn(params, cache, tokens, cur_index):
        """The cache, of any length, is laid out by the rules; it is written
        in place where it already was (prefill's output is), and
        returned."""
        params = distribute(params, param_sh, mesh)
        cache = distribute(cache, shardings_from_axes(cache, cache_axes, mesh,
                                                      rules), mesh)
        tokens = distribute(tokens, tok_sh, mesh)
        tok, cache = run(inner, params, cache, tokens, int(cur_index))
        return distribute(tok, tok_sh, mesh), cache

    return ShardedStep("decode", fn, (param_abs, cache_abs, tok_abs,
                                      _sds_i32()),
                       rules, mesh, (param_sh, cache_sh, tok_sh, None))
