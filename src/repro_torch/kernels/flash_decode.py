"""Flash-decode: one new token of GQA attention against a KV cache.

Port of the Pallas TPU kernel ``repro/kernels/flash_decode.py::
flash_decode_bkgd``. On a CUDA tensor :func:`flash_decode` launches the
hand-written kernel in ``csrc/flash_decode.cu`` (one launch per call: a
long cache is split across the blocks of one thread-block cluster, whose
partials are merged through distributed shared memory; bfloat16 runs its
products on the tensor cores, float32 on the CUDA cores; see the source for
the design); on a CPU tensor it runs :func:`flash_decode_plain`. Any other
device raises.

Layout (the model's, read through strides, no copy): q (B, H, D);
k, v (B, S, K, D); kpos (S,) int32 absolute position per cache slot
(< 0 = invalid). Head h = kh*G + g with G = H // K.

With ``return_lse`` both versions also give each query row's log-sum-exp
(B, H) f32, so that calls over disjoint slots (a cache sharded over its
slots across ranks) merge as the kernel merges its cluster's splits
(``models/flash_xla.py::merge``). A row with no live slot merges with
weight 0: the kernel writes out 0 and lse NEG_INF + log(1e-37) for it, the
plain version the mean of the masked slots and lse NEG_INF + log S.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MAX_G = 16
MAX_D = 256
MAX_SPLIT = 8           # the portable thread-block cluster size
MIN_SPLIT_KEYS = 256    # no split shorter than this unless there is one
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SM_COUNT: Dict[int, int] = {}


def flash_decode_plain(q, k, v, kpos, cur, *, window: int = 0,
                       cap: float = 0.0, return_lse: bool = False):
    """Plain PyTorch version (port of ``ref.flash_decode_ref``): full scores
    in f32, masked with the finite NEG_INF, softmax, p rounded to v's dtype
    before the PV product. With ``return_lse`` also (B, H) f32
    m + log(max(l, 1e-37))."""
    B, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, K, G, D) * D ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    valid = (kpos >= 0) & (kpos <= cur)
    if window:
        valid &= kpos > cur - window
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / l
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = out.to(v.dtype).reshape(B, H, D)
    if not return_lse:
        return out
    return out, (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0].reshape(B, H)


def _kernel():
    """The launch function of the built library."""
    lib = build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [I, P, L, L, P, L, L, L, P, L, L, L, P, P, P,
                       I, I, I, I, I, I, I, I, ctypes.c_float,
                       ctypes.c_float, P]
        fn.restype = I
    return fn


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def split_plan(B: int, K: int, S: int, sms: int) -> int:
    """Blocks (one cluster) per (b, kh) row: one when the cache is short;
    otherwise as many as keep every split at least ``MIN_SPLIT_KEYS`` keys
    long, at most ``MAX_SPLIT``, and about one wave of blocks over the
    ``sms`` multiprocessors. Split i reads keys [i*S // n_split,
    (i+1)*S // n_split)."""
    return max(1, min(MAX_SPLIT, S // MIN_SPLIT_KEYS, sms // (B * K)))


def _check(q, k, v, kpos):
    dev = q.device
    if any(t.device != dev for t in (k, v, kpos)):
        raise ValueError("flash_decode: q, k, v and kpos must share a device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q/k/v must all be float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: want q (B,H,D), k/v (B,S,K,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % K:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)}")
    if H // K > MAX_G or D > MAX_D:
        raise ValueError(f"flash_decode: G={H // K} > {MAX_G} or "
                         f"D={D} > {MAX_D} is not supported")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_decode: the head dim must be contiguous")
    for name, t in (("k", k), ("v", v)):      # 16-byte cp.async copies
        step = 16 // t.element_size()
        if (t.data_ptr() % 16 or D % step
                or any(t.stride(i) % step for i in range(3) if t.shape[i] > 1)):
            raise ValueError(f"flash_decode: {name} needs a 16-byte aligned "
                             f"base, D and every stride a multiple of {step} "
                             f"elements; got D={D}, strides {t.stride()}")
    if (kpos.dtype != torch.int32 or kpos.shape != (S,)
            or not kpos.is_contiguous()):
        raise ValueError("flash_decode: kpos must be a contiguous int32 (S,)")


def flash_decode(q, k, v, kpos, cur, *, window: int = 0, cap: float = 0.0,
                 return_lse: bool = False):
    """q (B,H,D); k, v (B,S,K,D); kpos (S,) -> (B,H,D) in q's dtype, and
    with ``return_lse`` the rows' log-sum-exp (B,H) f32 too.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. ``flash_decode.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kpos, cur, window=window, cap=cap,
                                  return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check(q, k, v, kpos)
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    n_split = split_plan(B, K, S, _sm_count(q.device))
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = _kernel()(
        _DTYPES[q.dtype],
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        kpos.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B, K, G, S, D, n_split, int(cur), int(window),
        float(cap), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0
