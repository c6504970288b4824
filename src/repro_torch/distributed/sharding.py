"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Model code annotates tensors with *logical* axis names ("batch", "heads",
"seq_kv", "experts", ...). A rules mapping, built per (config, step kind,
shape, mesh), resolves each logical axis to zero or more mesh axes. Two
attention TP modes fall out of the same model code:

* ``heads`` mode (n_heads divisible by the model axis): Megatron-style,
  QKV/O sharded over heads, attention compute local per shard.
* ``context`` mode (n_heads not divisible): QKV/O weights sharded over the
  contracting d_model dim and the decode cache over the KV-sequence dim.
  The reference combines partial softmaxes across that dim; the port
  gathers K/V (or the cache) over the model axis before the local kernel
  call (``kernels.ops``), which gives the same result with other
  collectives.

All constraints are best-effort: a mesh axis that does not evenly divide
the corresponding dim is dropped.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``. ``spec_for`` returns the reference's per-tensor-dim
form (a mesh-axis name, a tuple of them, or None per dim, as a
``PartitionSpec`` holds); ``placements`` turns it into DTensor placements,
one per mesh dim: ``Shard(i)`` on every mesh dim that tensor dim ``i``
names, ``Replicate()`` on the others. A "sharding" below is such a tuple of
placements.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import params as pspec
from repro_torch.utils import tree_leaves, tree_leaves_like, tree_unflatten

Rules = dict


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size}: the reference's ``mesh.shape`` (empty for no
    mesh)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def heads_divisible(cfg: ModelConfig, mesh) -> bool:
    return cfg.n_heads % axis_sizes(mesh).get("model", 1) == 0


def kv_heads_divisible(cfg: ModelConfig, mesh) -> bool:
    return cfg.n_kv_heads % axis_sizes(mesh).get("model", 1) == 0


def attn_mode(cfg: ModelConfig, mesh, step_kind: str) -> str:
    """heads | context, chosen per (arch, step kind)."""
    if cfg.pattern and all(k == "ssm" for k in cfg.pattern):
        return "heads"  # irrelevant; ssm uses its own axes
    if step_kind == "decode":
        # The KV cache is the dominant tensor: shard it over kv-heads when
        # possible, otherwise over the sequence dim (context mode).
        return "heads" if kv_heads_divisible(cfg, mesh) else "context"
    return "heads" if heads_divisible(cfg, mesh) else "context"


def make_rules(mesh, cfg: ModelConfig, step_kind: str,
               shape: Optional[ShapeSpec] = None) -> Rules:
    dp = _dp_axes(mesh)
    model = ("model",) if "model" in axis_sizes(mesh) else ()
    mode = attn_mode(cfg, mesh, step_kind)
    batch = shape.global_batch if shape is not None else None

    if step_kind == "decode" and batch == 1:
        # Nothing to data-parallelize: give the whole mesh to the sequence /
        # state dims (long-context decode).
        batch_axes = ()
        seq_kv = dp + model if mode == "context" else ()
    else:
        batch_axes = dp
        seq_kv = model if mode == "context" else ()

    rules = {
        "batch": batch_axes,
        "seq": (),
        "seq_act": (model if (step_kind == "train" and cfg.seq_shard_train)
                    else ()),
        "seq_kv": seq_kv,
        "kv_seg": seq_kv,   # segment dim of combine-once context flash
        "heads": model if mode == "heads" else (),
        "heads_o": model if heads_divisible(cfg, mesh) else (),
        "d_model_out": (model if (mode == "context"
                                  and not heads_divisible(cfg, mesh))
                        else ()),
        "kv_heads": model if (mode == "heads"
                              and kv_heads_divisible(cfg, mesh)) else (),
        "head_dim": (),
        "d_model": (),
        "d_model_tp": model if mode == "context" else (),
        "d_ff": model,
        "vocab": model,
        "experts": dp,
        "expert_ff": model,
        "ssm_heads": (),
        "ssm_hd": model,
        "ssm_state": (),
        "d_rnn": model,
        "conv_w": (),
        "layers": (),
        "frames": (),
        "patches": (),
    }
    rules["_mode"] = mode
    return rules


def spec_for(rules: Rules, axes, shape=None) -> tuple:
    """Per-dim mesh axes from logical axes (None, a name, or a tuple of
    names, as the reference's PartitionSpec), dropping axes that do not
    divide the dim and axes already used by an earlier dim."""
    sizes = axis_sizes(_CTX.mesh)
    used = set()
    out = []
    for i, ax in enumerate(axes):
        mesh_axes = rules.get(ax, ()) if ax is not None else ()
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        picked = []
        total = 1
        for m in mesh_axes:
            if m in used or m not in sizes:
                continue
            total *= sizes[m]
            picked.append(m)
        if shape is not None and picked and shape[i] % total != 0:
            # Best effort: retry with a prefix of the axes.
            picked2, total2 = [], 1
            for m in picked:
                if shape[i] % (total2 * sizes[m]) == 0:
                    picked2.append(m)
                    total2 *= sizes[m]
            picked = picked2
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return tuple(out)


def placements(mesh, spec) -> tuple:
    """DTensor placements, one per mesh dim, for a ``spec_for`` result
    (``Replicate`` on a mesh dim of one rank, which splits nothing: on a
    one-rank mesh every placement is ``Replicate``).

    A tuple entry names its mesh axes major to minor, as JAX reads it;
    DTensor shards one tensor dim over several mesh dims in mesh-dim order,
    so the entry must list them in that order (every rule does), and then
    the rank at each mesh position holds the reference's slice."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(m) for m in
                ((entry,) if isinstance(entry, str) else entry)]
        if dims != sorted(dims):
            raise ValueError(f"mesh axes {entry} of dim {i} are not in the "
                             f"mesh's order {names}")
        for d in dims:
            if mesh.size(d) > 1:    # a mesh dim of one rank splits nothing
                out[d] = Shard(i)
    return tuple(out)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Rules] = None
        self.cache_rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Rules],
              cache_rules: Optional[Rules] = None):
    """Lay model code out on ``mesh`` by ``rules`` in this thread, and a
    prefill's cache by ``cache_rules`` where given (``constrain_cache``).
    Under a mesh, a plain tensor that meets a DTensor (positions, masks,
    RoPE frequencies) counts as replicated (DTensor's
    ``implicit_replication``, entered by the outermost ``use_rules`` of the
    thread)."""
    old = (_CTX.mesh, _CTX.rules, _CTX.cache_rules)
    _CTX.mesh, _CTX.rules, _CTX.cache_rules = mesh, rules, cache_rules
    try:
        with (implicit_replication() if mesh is not None and old[0] is None
              else contextlib.nullcontext()):
            yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.cache_rules = old


def current_mesh_rules():
    return _CTX.mesh, _CTX.rules


def backward_under_rules(loss):
    """Run the backward of ``loss`` under the current rules, on whichever
    thread autograd runs it: a CUDA backward runs on a thread of its own,
    which gets the caller's C++ thread-local state (DTensor's implicit
    replication) but not Python's thread-locals, so remat's recompute would
    find no rules. A hook on ``loss``, the backward's first node, enters
    ``use_rules`` on that thread, and a callback at the backward's end, on
    the same thread, leaves it. A no-op outside a mesh."""
    mesh, rules = current_mesh_rules()
    if mesh is None:
        return

    def enter(grad):
        ctx, me = use_rules(mesh, rules), threading.get_ident()
        ctx.__enter__()

        def leave():
            if threading.get_ident() == me:
                ctx.__exit__(None, None, None)

        torch.autograd.Variable._execution_engine.queue_callback(leave)
        return grad

    loss.register_hook(enter)


def current_placements(shape, *axes) -> Optional[tuple]:
    """The placements the current rules give a tensor of ``shape`` with
    logical ``axes``; None outside ``use_rules``."""
    if _CTX.mesh is None or _CTX.rules is None:
        return None
    return placements(_CTX.mesh, spec_for(_CTX.rules, axes, tuple(shape)))


def shard_groups(placements, dim: int) -> list:
    """(process group, this rank's index) of each mesh dim that shards
    tensor dim ``dim`` of a tensor with ``placements``, in mesh order."""
    mesh, _ = current_mesh_rules()
    return [(mesh.get_group(i), mesh.get_local_rank(i))
            for i, p in enumerate(placements) if p.is_shard(dim)]


def shard_offset(groups, n_loc: int) -> int:
    """The first index of this rank's shard of a dim split over ``groups``
    (``shard_groups``) into shards of ``n_loc``: its index over the
    groups, major to minor, times ``n_loc``."""
    idx = 0
    for group, index in groups:
        idx = idx * group.size() + index
    return idx * n_loc


def all_reduce_over(x, op: str, groups):
    """``x`` reduced by ``op`` over the process group of each (group,
    index) of ``groups`` in turn (``shard_groups``)."""
    for group, _ in groups:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, group))
    return x


class _ConstrainGrad(torch.autograd.Function):
    """The identity, whose backward lays the cotangent out as ``placements``
    (on ``mesh``): JAX transposes ``with_sharding_constraint`` to the same
    constraint on the cotangent, and without it DTensor may carry a
    gradient replicated where the forward kept it sharded, and then compute
    the backward's products on the whole width on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


def constrain(x, *axes):
    """Lay a DTensor out by logical axes, and its gradient in the backward
    (the reference's with_sharding_constraint); a no-op outside use_rules
    and for a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    pl = current_placements(x.shape, *axes)
    if pl is None:
        return x
    if tuple(x.placements) != tuple(pl):
        x = x.redistribute(_CTX.mesh, pl)
    if x.requires_grad and torch.is_grad_enabled():
        x = _ConstrainGrad.apply(x, _CTX.mesh, tuple(pl))
    return x


def constrain_cache(x, *axes):
    """Lay a cache leaf that prefill makes out as decode reads it (the
    ``cache_rules`` of ``use_rules``) as soon as it is made, so the step
    holds each layer's shard, not the whole, as the reference's
    ``out_shardings`` lay out its emitted cache; ``x`` as it is without
    cache rules or outside a mesh."""
    if _CTX.cache_rules is None or not isinstance(x, DTensor):
        return x
    pl = placements(_CTX.mesh, spec_for(_CTX.cache_rules, axes,
                                        tuple(x.shape)))
    return x if tuple(x.placements) == pl else x.redistribute(_CTX.mesh, pl)


def shardings_for(tree, mesh, rules: Rules):
    """Placements for every ParamSpec of a spec tree."""
    with use_rules(mesh, rules):
        return pspec.tree_map_specs(
            lambda s: placements(mesh, spec_for(rules, s.axes,
                                                tuple(s.shape))), tree)


def shardings_from_axes(abstract_tree, axes_tree, mesh, rules: Rules):
    """Placements for a tree of tensors (meta or real) and a parallel tree
    carrying a tuple of logical axis names where ``abstract_tree`` has a
    tensor."""
    flat = tree_leaves(abstract_tree)
    axes_flat = tree_leaves_like(axes_tree, abstract_tree)
    with use_rules(mesh, rules):
        out = [placements(mesh, spec_for(rules, axes, tuple(t.shape)))
               for t, axes in zip(flat, axes_flat)]
    return tree_unflatten(abstract_tree, out)


def replicated(mesh) -> tuple:
    return (Replicate(),) * len(mesh.mesh_dim_names)


def distribute(tree, shardings, mesh):
    """``tree`` laid out on ``mesh`` by ``shardings`` (placements where
    ``tree`` has a tensor): a DTensor is redistributed, and kept as it is
    when its placements already match (so a cache written in place stays the
    caller's); any other tensor or array goes to the mesh's device type and
    is distributed from rank 0's copy."""
    out = []
    for t, pl in zip(tree_leaves(tree), tree_leaves_like(shardings, tree)):
        if isinstance(t, DTensor):
            out.append(t if tuple(t.placements) == tuple(pl)
                       else t.redistribute(mesh, pl))
        else:
            out.append(distribute_tensor(
                torch.as_tensor(t).to(mesh.device_type), mesh, pl))
    return tree_unflatten(tree, out)
