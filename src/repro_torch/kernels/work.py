"""The kernels' own work, counted by formula (the dry run's flops).

A CPU tensor runs each kernel's plain version, whose ops are not the
kernel's work on the card: the plain attention scores every (q, k) pair
under its mask, and the plain SSD scan multiplies whole chunk squares.
While a counter is on (``counting``; ``launch/dryrun.py``'s recorder turns
itself on), each wrapper reports its kernel's operations by the formulas
``chip_smoke.py`` bounds the kernels with, and the counter skips the ops and
the temporary buffers of the plain version inside (``plain``): the plain
attention's (B, H, Sq, Skv) f32 scores are not the kernel's. With no
counter on nothing changes.
"""
from __future__ import annotations

import contextlib

import numpy as np

_COUNTERS: list = []


@contextlib.contextmanager
def counting(counter):
    """While open, ``counter.kernel(name, flops)`` hears of each kernel
    call, ``counter.in_kernel`` is above 0 inside its plain version, and
    ``counter.kernel_outputs(out)`` gets what the call returns."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


def plain(name: str, flops, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a kernel's plain version. With a counter on,
    ``flops()`` (the kernel's operations) is reported to it, and it counts
    neither the ops inside nor their buffers, only the outputs the call
    returns (the kernel's own buffers on the card)."""
    if not _COUNTERS:
        return fn(*args, **kwargs)
    n = int(flops())
    counters = list(_COUNTERS)
    for c in counters:
        c.kernel(name, n)
        c.in_kernel += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        for c in counters:
            c.in_kernel -= 1
    for c in counters:
        c.kernel_outputs(out)
    return out


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int,
                    k0: int = 0) -> int:
    """The (q, k) pairs attention keeps, query i at position i and key row
    j at k0 + j (``flash_attention._mask``'s count)."""
    i = np.arange(Sq, dtype=np.int64) - k0
    hi = np.minimum(Skv, i + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo, 0, None).sum())


def attention_flops(B: int, H: int, D: int, pairs: int,
                    backward: bool = False) -> int:
    """4·D a live (q, k) pair and head forward (QKᵀ, PV); 10·D backward
    (the scores again, dOVᵀ, dV, dK, dQ)."""
    return (10 if backward else 4) * D * B * H * pairs


def _chunk_pairs(L: int, Q: int) -> int:
    full, rest = divmod(L, Q)
    return full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2


def ssd_flops(B: int, L: int, H: int, P: int, N: int, Q: int,
              backward: bool = False) -> int:
    """The SSD scan's least operations. Forward: C·Bᵀ once per chunk for
    all heads on and below the diagonal; per head the weighted scores
    times x·dt over the same pairs, the chunk states and the inter-chunk
    term (2·L·P·N each). Backward: C·Bᵀ again; per head dy·uᵀ, the
    weighted scores times dy, (L∘M) times B and C on the same pairs, and
    six (P, N) products a row."""
    pairs = _chunk_pairs(L, min(Q, L))
    if backward:
        return B * (2 * N * pairs + H * ((4 * P + 4 * N) * pairs
                                         + 12 * L * P * N))
    return B * (2 * N * pairs + H * (2 * P * pairs + 4 * L * P * N))
