"""Flash attention over a whole sequence (prefill and the train forward),
and its backward.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_bhsd``. On a CUDA tensor :func:`flash_attention` launches
the hand-written kernel in ``csrc/flash_attention.cu`` (one block per
64-row q tile and head, walking only the live key tiles; see the source);
on a CPU tensor it runs :func:`flash_attention_plain`. Any other device
raises. The kernel is chosen by dtype: bfloat16 (the models' type) runs on
the tensor cores (wgmma) with K/V tiles brought by TMA; float32 (the parity
cases) runs the CUDA-core kernel.

The gradient: when grad is enabled and an input requires it,
:func:`flash_attention` goes through :class:`FlashAttention`, an
``autograd.Function`` (the port of the ``custom_vjp`` of
``repro/models/flash_xla.py::_make_flash``). Its forward runs the forward
with the row log-sum-exp ``lse`` (B, H, Sq) f32 as a second output, and
its backward :func:`flash_attention_bwd`: on a CUDA tensor the
hand-written kernels of ``csrc/flash_attention_bwd.cu``, on a CPU tensor
:func:`flash_attention_bwd_plain`, the port of that ``custom_vjp``'s
``bwd``. There is no plain path on the card.

Layout (the model's, read through strides, no copy): q (B, Sq, H, D);
k, v (B, Skv, K, D); query head h reads kv head h // G with G = H // K.
Query positions start at 0, key positions at ``k0`` (0 unless the keys are
one segment of a longer sequence: ``models/flash_xla.py``'s
segment-parallel path, where each segment's partial output and ``lse`` are
merged, and each segment's backward runs against the merged ones). A query
row that sees no key of a segment merges with weight 0: the kernel writes
out 0 and lse NEG_INF + log(1e-37) for it (where its q tile has no live key
tile), the plain version the mean of the masked keys and lse NEG_INF + log
Skv; compare the two on the rows that see a key.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.flash_decode import _sm_count

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mask(Sq: int, Skv: int, causal: bool, window: int, device, k0: int = 0):
    """(Sq, Skv) bool: the (q, k) pairs attention keeps, key row j at
    position k0 + j."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = k0 + torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          cap: float = 0.0, return_lse: bool = False,
                          k0: int = 0):
    """Plain PyTorch version (port of ``ref.flash_attention_ref``, in the
    model layout): full scores in f32, masked with the finite NEG_INF,
    softmax, p rounded to v's dtype before the PV product. With
    ``return_lse`` also the row log-sum-exp m + log(max(l, 1e-37)), (B, H,
    Sq) f32, as ``flash_xla._fwd_impl`` returns it."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, D) * D ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    s = torch.where(_mask(Sq, Skv, causal, window, q.device, k0), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / l
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    out = out.to(v.dtype).reshape(B, Sq, H, D)
    if not return_lse:
        return out
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0, cap: float = 0.0, k0: int = 0):
    """Plain PyTorch backward (port of the ``bwd`` of
    ``repro/models/flash_xla.py::_make_flash``, with full scores in place of
    its key chunks): delta = rowsum(dout·out) in f32; the scores recomputed
    in f32 and p = exp(s - lse); p rounded to dout's dtype before dv;
    ds = p·(dp - delta), times (1 - t²) under a softcap, rounded to q's
    dtype before dq and dk; dq summed in f32 and scaled once at the end.
    lse (B, H, Sq) f32. Returns (dq, dk, dv) in q's, k's and v's dtypes.
    With keys from position ``k0`` and the merged out and lse of all
    segments this is one segment's part of the ``bwd`` of
    ``_make_seg_flash``: its own dk, dv and its share of dq."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    qf = q.float().reshape(B, Sq, K, G, D)
    do = dout.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf * scale, k.float())
    if cap:
        t = torch.tanh(s / cap)
        s = cap * t
    s = torch.where(_mask(Sq, Skv, causal, window, q.device, k0), s, NEG_INF)
    p = torch.exp(s - lse.float().reshape(B, K, G, Sq)[..., None])
    delta = torch.einsum("bqkgd,bqkgd->bkgq", do,
                         out.float().reshape(B, Sq, K, G, D))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(dout.dtype).float(), do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - delta[..., None])
    if cap:
        ds = ds * (1.0 - t * t)
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.to(q.dtype).reshape(B, Sq, H, D), dk.to(k.dtype),
            dv.to(v.dtype))


def _kernel():
    """(launch function, largest head dim) of the built library."""
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [I, P, L, L, L, P, L, L, L, P, L, L, L, P, P,
                       I, I, I, I, I, I, I, I, I, ctypes.c_float,
                       ctypes.c_float, P]
        fn.restype = I
        lib.flash_attention_max_d.argtypes = []
        lib.flash_attention_max_d.restype = I
    return fn, lib.flash_attention_max_d()


def _check(q, k, v, max_d: int):
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must all be float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B,Sq,H,D), k/v "
                         f"(B,Skv,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)}")
    if D > max_d:
        raise ValueError(f"flash_attention: D={D} > {max_d} is not supported")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16:
        check_tma_layout(q, k, v)


def _vector_readable(t):
    """Whether 16-byte copies (TMA, or the bf16 backward's loads) can read
    the rows of a bf16 (B, S, heads, D) tensor as it is: the base 16-byte
    aligned and every stride of a dim longer than one a positive multiple
    of 8 elements."""
    if t.data_ptr() % 16:
        return False
    (n0, n1, n2), (s0, s1, s2) = t.shape[:3], t.stride()[:3]
    return ((n0 == 1 or (s0 > 0 and s0 % 8 == 0))
            and (n1 == 1 or (s1 > 0 and s1 % 8 == 0))
            and (n2 == 1 or (s2 > 0 and s2 % 8 == 0)))


def check_tma_layout(q, k, v):
    """Raise unless the bf16 kernel's TMA loads can read q, k and v as they
    are: D a multiple of 16, each base 16-byte aligned and every stride of a
    dim longer than one a multiple of 16 bytes."""
    D = q.shape[-1]
    if D % 16:
        raise ValueError(f"flash_attention: bf16 needs D a multiple of 16, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _vector_readable(t):
            raise ValueError(
                f"flash_attention: {name} {tuple(t.shape)} with strides "
                f"{t.stride()} cannot be read by TMA: the base must be "
                f"16-byte aligned and every stride a multiple of 8 elements")


def _strides(t):
    """Strides of dims 0-2 for the kernel. A dim of length one is never
    stepped over, so its stride is rounded up to one TMA accepts."""
    return [t.stride(i) if t.shape[i] > 1 else max(8, -(-t.stride(i) // 8) * 8)
            for i in range(3)]


def _work(q, k, causal, window, k0, backward=False) -> int:
    """The kernel's operations on these shapes (``kernels/work.py``)."""
    B, Sq, H, D = q.shape
    return work.attention_flops(
        B, H, D, work.attention_pairs(Sq, k.shape[1], causal, window, k0),
        backward)


def _forward(q, k, v, causal: bool, window: int, cap: float,
             want_lse: bool, k0: int = 0):
    """(out, lse or None): the plain version on the CPU, the kernel on the
    card (lse written only when asked for: a null pointer otherwise); keys
    from position ``k0``."""
    if q.device.type == "cpu":
        out = work.plain("flash_attention",
                         lambda: _work(q, k, causal, window, k0),
                         flash_attention_plain, q, k, v, causal=causal,
                         window=window, cap=cap, return_lse=want_lse, k0=k0)
        return out if want_lse else (out, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    launch, max_d = _kernel()
    _check(q, k, v, max_d)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    rc = launch(
        _DTYPES[q.dtype],
        q.data_ptr(), *_strides(q),
        k.data_ptr(), *_strides(k),
        v.data_ptr(), *_strides(v),
        out.data_ptr(), lse.data_ptr() if want_lse else None,
        B, H, H // K, Sq, Skv, D, int(bool(causal)),
        int(window), int(k0), float(cap), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


def _bwd_kernel():
    """(launch function, largest head dim) of the backward's library."""
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([I] + [P, L, L, L] * 5 + [P] * 7 + [I] * 9
                       + [ctypes.c_float, ctypes.c_float, P, I, P])
        fn.restype = I
        lib.flash_attention_bwd_max_d.argtypes = []
        lib.flash_attention_bwd_max_d.restype = I
    return fn, lib.flash_attention_bwd_max_d()


BWD_TILE = 64       # keys (dk/dv), queries (dq) a tile of the bf16 kernels


def _bwd_width(D: int) -> int:
    """The head width the bf16 backward runs D at: the next of 16, 32, 64,
    128, 256."""
    return next(w for w in (16, 32, 64, 128, 256) if w >= D)


def bwd_panel(D: int):
    """(accumulator columns a block owns, panels of D) of the bf16
    backward: D runs at ``_bwd_width(D)``, split into panels of at most
    128 columns."""
    ap = min(_bwd_width(D), 128)
    return ap, -(-D // ap)


def _live_q_tiles(k0: int, Sq: int, causal: bool, window: int):
    """(first query row, live query tiles) the bf16 dk/dv kernel walks for
    the key tile from position k0 (its row plus the key offset)."""
    q_lo = k0 if causal else 0
    q_hi = min(Sq, k0 + BWD_TILE - 1 + window) if window else Sq
    first = q_lo // BWD_TILE * BWD_TILE
    return first, (-(-(q_hi - first) // BWD_TILE) if q_hi > first else 0)


def _longest_dq_walk(Sq: int, Skv: int, causal: bool, window: int,
                     koff: int = 0) -> int:
    """Key tiles the longest bf16 dq block walks (the forward's walk),
    key row j at position koff + j."""
    most = 0
    for q0 in range(0, Sq, BWD_TILE):
        k_begin = max(0, q0 - koff - window + 1) if window else 0
        k_end = min(Skv, q0 - koff + BWD_TILE) if causal else Skv
        first = k_begin // BWD_TILE * BWD_TILE
        if k_end > first:
            most = max(most, -(-(k_end - first) // BWD_TILE))
    return most


@functools.lru_cache(maxsize=512)
def dkdv_plan(B: int, K: int, G: int, Sq: int, Skv: int, causal: bool,
              window: int, panels: int, slots: int, koff: int = 0):
    """(wt, rows) of the bf16 dk/dv blocks. Key tile j of a (panel, b, kv
    head) has G * nq_j items (its nq_j live query tiles, for each of the G
    query heads, heads in order: item i is query head kh * G + i // nq_j,
    query tile i % nq_j); it is cut into n_c = max(1, ceil(G * nq_j / wt))
    runs of items, one block each. ``rows`` holds one row per block in
    launch order, (key tile j, first live query row, nq_j, first item, end
    item, the tile's first row, n_c, 0): the kernel reads its block's row
    and nothing else of the plan. The launch runs these blocks first, then
    the dq blocks longest first. wt is the larger of the dk/dv items per
    slot of the card (``slots`` resident blocks) and the longest dq walk: no
    block is longer than the card's share needs, and the chunks start before
    any longer block. Where a wt at most a quarter larger fits every chunk
    in one wave of ``slots``, it is taken: a chunk left to a second wave
    would start only as the first ends. ``koff`` is the key offset: key
    tile j starts at position koff + 64 j."""
    live = [_live_q_tiles(koff + k0, Sq, causal, window)
            for k0 in range(0, Skv, BWD_TILE)]
    units = panels * B * K

    def blocks(wt):
        return sum(max(1, -(-G * n // wt)) for _, n in live)

    wt = max(1, -(-units * G * sum(n for _, n in live) // slots),
             _longest_dq_walk(Sq, Skv, causal, window, koff))
    if units * blocks(wt) > slots:
        wt = next((w for w in range(wt + 1, wt + wt // 4 + 1)
                   if units * blocks(w) <= slots), wt)
    rows = []
    for j, (first, n) in enumerate(live):
        w, start = G * n, len(rows)
        n_c = max(1, -(-w // wt))
        rows += [(j, first, n, c * w // n_c, (c + 1) * w // n_c, start, n_c, 0)
                 for c in range(n_c)]
    return wt, tuple(rows)


@functools.lru_cache(maxsize=512)
def _dkdv_table(device, B, K, G, Sq, Skv, causal, window, panels, slots,
                koff=0):
    """dkdv_plan's rows as a (blocks, 8) int32 tensor on ``device``,
    copied there once per shape (so a CUDA graph captures a call only after
    an eager call at its shape, as warm-up before a capture gives)."""
    _, rows = dkdv_plan(B, K, G, Sq, Skv, causal, window, panels, slots,
                        koff)
    return torch.tensor(rows, dtype=torch.int32).to(device)


_DKDV_SLOTS = {}


def _dkdv_slots(device, D: int) -> int:
    """dk/dv blocks the card holds at once at head dim D: the library's
    occupancy for the kernel (registers, shared memory) times the SMs."""
    key = (device.index, _bwd_width(D))
    if key not in _DKDV_SLOTS:
        lib = build.load("flash_attention_bwd")
        fn = lib.flash_attention_bwd_dkdv_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        per_sm = fn(D)
        if per_sm < 1:
            raise RuntimeError(f"flash_attention_bwd: no occupancy for D={D}")
        _DKDV_SLOTS[key] = per_sm * _sm_count(device)
    return _DKDV_SLOTS[key]


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, cap: float = 0.0, k0: int = 0):
    """(dq, dk, dv) of attention given the forward's out and lse (B, H, Sq)
    f32 and the output gradient dout (B, Sq, H, D); keys from position
    ``k0`` (a segment's part, given the merged out and lse). CPU tensors run
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the kernels of
    ``csrc/flash_attention_bwd.cu`` (statistics, dk/dv, dq: one call, one
    count in ``flash_attention_bwd.launches``) or raise."""
    if q.device.type == "cpu":
        return work.plain("flash_attention_bwd",
                          lambda: _work(q, k, causal, window, k0, True),
                          flash_attention_bwd_plain, q, k, v, out, lse, dout,
                          causal=causal, window=window, cap=cap, k0=k0)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    launch, max_d = _bwd_kernel()
    _check(q, k, v, max_d)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16
                                and not _vector_readable(dout)):
        dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1 or (t.dtype == torch.bfloat16
                                         and not _vector_readable(t))):
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} does not match q")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"f32 (B, H, Sq) on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    part = count = plan = None
    n_chunks = 0
    if q.dtype == torch.bfloat16:
        # one f32 scratch: the statistics (B, H, q tiles, 2, 64), a counter
        # per (panel, b, kv head, key tile), and the f32 partials of the
        # dk/dv chunks when a key tile is cut into several
        ap, panels = bwd_panel(D)
        table = _dkdv_table(q.device, B, K, H // K, Sq, Skv, bool(causal),
                            int(window), panels, _dkdv_slots(q.device, D),
                            int(k0))
        plan, n_chunks = table.data_ptr(), table.shape[0]
        n_stats = B * H * -(-Sq // BWD_TILE) * 2 * BWD_TILE
        n_count = panels * B * K * -(-Skv // BWD_TILE)
        n_part = (panels * B * K * n_chunks * 2 * BWD_TILE * ap
                  if n_chunks > -(-Skv // BWD_TILE) else 0)
        off = -(-(n_stats + n_count) // 4) * 4     # partials 16-byte aligned
        delta = torch.empty(off + n_part, dtype=torch.float32,
                            device=q.device)     # the statistics first
        count = delta.data_ptr() + 4 * n_stats
        part = delta.data_ptr() + 4 * off if n_part else None
    else:
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Skv, K, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Skv, K, D), dtype=v.dtype, device=q.device)
    rc = launch(
        _DTYPES[q.dtype],
        *(x for t in (q, k, v, out, dout)
          for x in (t.data_ptr(), *_strides(t))),
        lse.data_ptr(), delta.data_ptr(), part, count, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, H // K, Sq, Skv, D,
        int(bool(causal)), int(window), int(k0), float(cap), D ** -0.5, plan,
        n_chunks,
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: cudaError {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: the forward saves (q, k, v, out,
    lse), the backward recomputes the scores from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        out, lse = _forward(q, k, v, causal, window, cap, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, cap)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, cap = ctx.mask
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, dout,
                                         causal=causal, window=window,
                                         cap=cap)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0):
    """q (B,Sq,H,D); k, v (B,Skv,K,D) -> (B,Sq,H,D) in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. When grad is enabled and an input requires it, the call goes
    through :class:`FlashAttention`, whose backward is
    :func:`flash_attention_bwd`. ``flash_attention.launches`` counts forward
    kernel launches."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                    float(cap))
    return _forward(q, k, v, causal, window, cap, want_lse=False)[0]


flash_attention.launches = 0
