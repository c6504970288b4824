"""Flash-decode: one new token of GQA attention against a KV cache.

Port of the Pallas TPU kernel ``repro/kernels/flash_decode.py::
flash_decode_bkgd``. On a CUDA tensor :func:`flash_decode` launches the
hand-written kernel in ``csrc/flash_decode.cu`` (sequence split across
blocks, then a combine kernel; see the source for the design); on a CPU
tensor it runs :func:`flash_decode_plain`. Any other device raises.

Layout (the model's, read through strides, no copy): q (B, H, D);
k, v (B, S, K, D); kpos (S,) int32 absolute position per cache slot
(< 0 = invalid). Head h = kh*G + g with G = H // K.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.utils import cdiv

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MAX_G = 16
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SM_COUNT: Dict[int, int] = {}


def flash_decode_plain(q, k, v, kpos, cur, *, window: int = 0,
                       cap: float = 0.0):
    """Plain PyTorch version (port of ``ref.flash_decode_ref``): full scores
    in f32, masked with the finite NEG_INF, softmax, p rounded to v's dtype
    before the PV product."""
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
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype).reshape(B, H, D)


def _kernel():
    """(launch function, keys per tile) of the built library."""
    lib = build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [I, P, L, L, P, L, L, L, P, L, L, L, P, P, P, P, P,
                       I, I, I, I, I, I, I, I, I, ctypes.c_float,
                       ctypes.c_float, P]
        fn.restype = I
        lib.flash_decode_tile.argtypes = []
        lib.flash_decode_tile.restype = I
    return fn, lib.flash_decode_tile()


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def split_plan(B: int, K: int, S: int, sms: int, tile: int):
    """(n_split, split_len): about two blocks per SM over the B*K rows, each
    split a whole number of ``tile``-key steps and none of them empty."""
    n_tiles = cdiv(S, tile)
    n_split = min(max(1, cdiv(2 * sms, B * K)), n_tiles)
    split_len = cdiv(n_tiles, n_split) * tile
    return cdiv(S, split_len), split_len


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
    if (kpos.dtype != torch.int32 or kpos.shape != (S,)
            or not kpos.is_contiguous()):
        raise ValueError("flash_decode: kpos must be a contiguous int32 (S,)")


def flash_decode(q, k, v, kpos, cur, *, window: int = 0, cap: float = 0.0):
    """q (B,H,D); k, v (B,S,K,D); kpos (S,) -> (B,H,D) in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. ``flash_decode.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kpos, cur, window=window, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check(q, k, v, kpos)
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    launch, tile = _kernel()
    n_split, split_len = split_plan(B, K, S, _sm_count(q.device), tile)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    part_m = torch.empty((B * K, n_split, G), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * K, n_split, G, D), dtype=torch.float32,
                           device=q.device)
    rc = launch(
        _DTYPES[q.dtype],
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        kpos.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        B, K, G, S, D, n_split, split_len, int(cur), int(window),
        float(cap), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
