"""GQA attention: full-sequence (prefill / train forward) and cached decode
(port of ``repro.models.attention``).

``attend_full`` runs its score/softmax/PV block through
``models.flash_xla.flash_attention_xla`` (``kernels.ops.flash_attention``
outside context mode) and ``attend_decode`` through
``kernels.ops.flash_decode``: the hand-written CUDA kernels on the card,
their plain PyTorch versions on the CPU. Cross-attention (encoder-decoder
models) takes its keys and values from the encoder output, applies no RoPE
and is never causal; its decode cache is the encoder's K/V, never written.
The reference's ``constrain`` calls sit at the same points (no-ops outside
a mesh), and heads mode expands K/V to one head per query head where the
KV heads do not shard (``_should_expand_kv``). In context mode
``attend_full`` takes the reference's segment-parallel combine
(``_context_segments``, ``models/flash_xla.py``): each rank of the model
axis attends over its segment of K/V and the ranks merge by lse; decode
merges each rank's cache shard the same way (``kernels.ops``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (axis_sizes, constrain,
                                              constrain_cache,
                                              current_mesh_rules)
from repro_torch.kernels import ops
from repro_torch.models import flash_xla
from repro_torch.models.layers import rope
from repro_torch.models.params import ParamSpec


def attn_spec(cfg: ModelConfig):
    """The same tree serves self- and cross-attention."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "w_q": ParamSpec((d, h, hd), ("d_model_tp", "heads", "head_dim")),
        "w_k": ParamSpec((d, k, hd), ("d_model_tp", "kv_heads", "head_dim")),
        "w_v": ParamSpec((d, k, hd), ("d_model_tp", "kv_heads", "head_dim")),
        "w_o": ParamSpec((h, hd, d), ("heads_o", "head_dim", "d_model_out")),
    }
    if cfg.qkv_bias:
        s["b_q"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        s["b_k"] = ParamSpec((k, hd), ("kv_heads", "head_dim"), init="zeros")
        s["b_v"] = ParamSpec((k, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def _project(eq: str, x, w):
    """``torch.einsum(eq, x, w)``: activations (B, S, d) by a weight. Where
    the mesh replicates the weight and splits x over its rows only (batch,
    and the sequence in Megatron-SP), each rank multiplies its own rows
    and the weight's gradient is Partial over those mesh dims, as XLA
    partitions it: DTensor's einsum flattens a sequence-split x into a
    strided shard that its view back cannot always take (smoke qwen3-moe's
    K/V on a (2, 4) mesh)."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)
            and all(pl.is_replicate() for pl in w.placements)
            and all(pl.is_replicate() or (pl.is_shard() and pl.dim < 2)
                    for pl in x.placements)
            and any(pl.is_shard() for pl in x.placements)):
        return torch.einsum(eq, x, w)
    grad = tuple(Partial() if pl.is_shard() else Replicate()
                 for pl in x.placements)
    return local_map(lambda a, b: torch.einsum(eq, a, b),
                     out_placements=list(x.placements),
                     in_placements=(x.placements, w.placements),
                     in_grad_placements=(x.placements, grad),
                     device_mesh=x.device_mesh)(x, w)


def _project_qkv(p, x, x_kv=None, positions=None, kv_positions=None,
                 theta: float = 10000.0, use_rope: bool = True):
    x_kv = x if x_kv is None else x_kv
    q = _project("bsd,dhx->bshx", x, p["w_q"])
    k = _project("bsd,dkx->bskx", x_kv, p["w_k"])
    v = _project("bsd,dkx->bskx", x_kv, p["w_v"])
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    if use_rope:
        q = rope(q, positions, theta)
        k = rope(k, kv_positions if kv_positions is not None else positions,
                 theta)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _should_expand_kv(cfg: ModelConfig) -> bool:
    """Expand KV to full heads when heads are mesh-sharded but KV heads are
    not shardable (heads mode with kv_heads not divisible)."""
    mesh, rules = current_mesh_rules()
    if rules is None:
        return False
    return rules.get("_mode") == "heads" and not rules.get("kv_heads")


def _context_segments() -> int:
    """Segment count for the combine-once context-parallel flash: the
    model-axis size when context mode shards the KV sequence."""
    mesh, rules = current_mesh_rules()
    if mesh is None or rules is None or rules.get("_mode") != "context":
        return 0
    return int(axis_sizes(mesh).get("model", 0))


def attend_full(p, cfg: ModelConfig, x, *, kind: str, positions,
                x_kv=None, kv_positions=None, cross: bool = False,
                causal: bool = True):
    """Train / prefill attention. x (B,S,d); positions (B,S). Returns
    (y, (k, v)): k/v post-RoPE (no RoPE for cross), unexpanded, for cache
    construction. Cross-attention reads x_kv (B,Skv,d) and is never
    causal."""
    q, k, v = _project_qkv(p, x, x_kv=x_kv, positions=positions,
                           kv_positions=kv_positions, theta=cfg.rope_theta,
                           use_rope=not cross)
    ke, ve = k, v
    if _should_expand_kv(cfg):
        G = q.shape[2] // k.shape[2]
        ke = k.repeat_interleave(G, dim=2)
        ve = v.repeat_interleave(G, dim=2)
    out = flash_xla.flash_attention_xla(
        q, ke, ve, causal=causal and not cross,
        window=cfg.window if kind == "local" else 0, cap=cfg.attn_softcap,
        segments=_context_segments())
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    y = torch.einsum("bshx,hxd->bsd", out, p["w_o"])
    return constrain(y, "batch", "seq", "d_model"), (k, v)


def _ring_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if (kind == "local" and cfg.sliding_kv and cfg.window) else 0


def make_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Zero cache for one attention layer (window-sized ring for local
    layers)."""
    W = _ring_window(cfg, kind)
    S = min(max_len, W) if W else max_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes():
    return ("batch", "seq_kv", "kv_heads", "head_dim")


def prefill_into_cache(cfg: ModelConfig, kind: str, k, v, max_len: int):
    """Build a decode cache from prefill K/V (ring-packed for local layers).
    The tensors are owned and contiguous: decode writes into them in
    place. Built by ``torch.cat`` alone, which DTensor lays out in every
    torch this runs on (``torch.roll`` has no DTensor strategy in torch
    2.11, and its ``F.pad`` returns placements for a one-dim mesh)."""
    B, S, K, D = k.shape
    W = _ring_window(cfg, kind)
    cap = min(max_len, W) if W else max_len

    def pack(t):
        if S > cap:                   # keep last `cap`, rolled by `shift`
            t, cut = t[:, S - cap:], cap - (S - cap) % cap
            return torch.cat([t[:, cut:], t[:, :cut]], dim=1)
        # zeros after the prefilled slots (none when S == cap: a copy)
        return torch.cat([t, t.new_zeros((B, cap - S, K, D))], dim=1)

    return {"k": constrain_cache(pack(k), *cache_axes()),
            "v": constrain_cache(pack(v), *cache_axes())}


def _write_slot(buf, slot: int, row):
    """buf[:, slot:slot+1] = row, in place; buf (B,S,K,D), row (B,1,K,D).
    A DTensor buffer is written through its local shard: the rank whose
    shard holds the slot writes it (a cache sharded over its slots, context
    mode's, has one such rank along those mesh dims)."""
    if not isinstance(buf, DTensor):
        buf[:, slot] = row[:, 0]
        return
    mesh, pl = buf.device_mesh, buf.placements
    row = row.redistribute(mesh, [Replicate() if q.is_shard(1) else q
                                  for q in pl]).to_local()
    coord, n, idx = mesh.get_coordinate(), 1, 0
    for i, q in enumerate(pl):
        if q.is_shard(1):
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    chunk = buf.shape[1] // n
    if idx * chunk <= slot < (idx + 1) * chunk:
        buf.to_local()[:, slot - idx * chunk] = row[:, 0]


def attend_decode(p, cfg: ModelConfig, x, cache, cur_index: int, *,
                  kind: str, cross: bool = False):
    """One-token decode. x (B,1,d). Returns (y, cache).

    Unlike the reference, which returns a new cache, the new token's K/V are
    written into ``cache`` in place and the same dict is returned. A cross
    cache (the encoder's K/V) is read whole and never written."""
    if cross:
        q = torch.einsum("bsd,dhx->bshx", x, p["w_q"])
        if "b_q" in p:
            q = q + p["b_q"]
        S = cache["k"].shape[1]
        # every slot live: positions 0..S-1, all at or before S-1
        kpos = torch.arange(S, dtype=torch.int32, device=x.device)
        out = ops.flash_decode(q, cache["k"], cache["v"], kpos, S - 1,
                               cap=cfg.attn_softcap)
        y = torch.einsum("bshx,hxd->bsd", out, p["w_o"])
        return constrain(y, "batch", "seq", "d_model"), cache
    B = x.shape[0]
    cur = int(cur_index)
    pos = torch.full((B, 1), cur, dtype=torch.int32, device=x.device)
    q = torch.einsum("bsd,dhx->bshx", x, p["w_q"])
    k_new = torch.einsum("bsd,dkx->bskx", x, p["w_k"])
    v_new = torch.einsum("bsd,dkx->bskx", x, p["w_v"])
    if "b_q" in p:
        q, k_new, v_new = q + p["b_q"], k_new + p["b_k"], v_new + p["b_v"]
    q = rope(q, pos, cfg.rope_theta)

    k_all, v_all = cache["k"], cache["v"]
    S = k_all.shape[1]
    W = _ring_window(cfg, kind)
    ring = bool(W) and S == W
    slot = cur % S if ring else cur
    # jax.lax.dynamic_update_slice clamps an out-of-range start to S-1
    slot = min(max(slot, 0), S - 1)
    _write_slot(k_all, slot, rope(k_new, pos, cfg.rope_theta).to(k_all.dtype))
    _write_slot(v_all, slot, v_new.to(v_all.dtype))
    k_all = constrain(k_all, *cache_axes())
    v_all = constrain(v_all, *cache_axes())
    kpos = torch.arange(S, dtype=torch.int32, device=x.device)
    if ring:                          # ring buffer: absolute pos per slot
        kpos = cur - torch.remainder(cur - kpos, S)

    out = ops.flash_decode(q, k_all, v_all, kpos, cur, window=W,
                           cap=cfg.attn_softcap)
    y = torch.einsum("bshx,hxd->bsd", out, p["w_o"])
    return constrain(y, "batch", "seq", "d_model"), cache
