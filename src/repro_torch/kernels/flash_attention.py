"""Flash attention over a whole sequence (prefill and the train forward).

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_bhsd``. On a CUDA tensor :func:`flash_attention` launches
the hand-written kernel in ``csrc/flash_attention.cu`` (one block per
64-row q tile and head, walking only the live key tiles; see the source);
on a CPU tensor it runs :func:`flash_attention_plain`. Any other device
raises. The kernel is chosen by dtype: bfloat16 (the models' type) runs on
the tensor cores (wgmma) with K/V tiles brought by TMA; float32 (the parity
cases) runs the CUDA-core kernel.

Layout (the model's, read through strides, no copy): q (B, Sq, H, D);
k, v (B, Skv, K, D); query head h reads kv head h // G with G = H // K.
Query and key positions both start at 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          cap: float = 0.0):
    """Plain PyTorch version (port of ``ref.flash_attention_ref``, in the
    model layout): full scores in f32, masked with the finite NEG_INF,
    softmax, p rounded to v's dtype before the PV product."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, D) * D ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype).reshape(B, Sq, H, D)


def _kernel():
    """(launch function, largest head dim) of the built library."""
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [I, P, L, L, L, P, L, L, L, P, L, L, L, P,
                       I, I, I, I, I, I, I, I, ctypes.c_float, ctypes.c_float,
                       P]
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no backward yet (it comes "
            "with the training port); run under torch.no_grad()")


def check_tma_layout(q, k, v):
    """Raise unless the bf16 kernel's TMA loads can read q, k and v as they
    are: D a multiple of 16, each base 16-byte aligned and every stride of a
    dim longer than one a multiple of 16 bytes."""
    D = q.shape[-1]
    if D % 16:
        raise ValueError(f"flash_attention: bf16 needs D a multiple of 16, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(t.stride(i) % 8 or t.stride(i) <= 0
                                    for i in range(3) if t.shape[i] > 1):
            raise ValueError(
                f"flash_attention: {name} {tuple(t.shape)} with strides "
                f"{t.stride()} cannot be read by TMA: the base must be "
                f"16-byte aligned and every stride a multiple of 8 elements")


def _strides(t):
    """Strides of dims 0-2 for the kernel. A dim of length one is never
    stepped over, so its stride is rounded up to one TMA accepts."""
    return [t.stride(i) if t.shape[i] > 1 else max(8, -(-t.stride(i) // 8) * 8)
            for i in range(3)]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0):
    """q (B,Sq,H,D); k, v (B,Skv,K,D) -> (B,Sq,H,D) in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise. ``flash_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    launch, max_d = _kernel()
    _check(q, k, v, max_d)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    rc = launch(
        _DTYPES[q.dtype],
        q.data_ptr(), *_strides(q),
        k.data_ptr(), *_strides(k),
        v.data_ptr(), *_strides(v),
        out.data_ptr(), B, H, H // K, Sq, Skv, D, int(bool(causal)),
        int(window), float(cap), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
