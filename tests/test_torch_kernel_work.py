"""The kernels' own work, as the dry run counts it (``kernels/work.py``).

* ``attention_pairs`` equals the (q, k) pairs of ``flash_attention._mask``
  (causal or not, with a window, with a segment's key offset k0).
* Under ``launch/dryrun.py``'s recorder, a CPU call of the attention and
  SSD wrappers, forward and backward, adds its kernel's formula to the
  flops (4·D a live pair and head forward, 10·D backward; the SSD scan's
  least operations), counts none of the plain version's own ops, and holds
  only the call's outputs toward the peak, not the plain version's
  (B, H, Sq, Skv) scores. Outside a recorder the wrappers return the plain
  versions' results unchanged.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import work
from repro_torch.launch.dryrun import _Recorder


@pytest.mark.parametrize("Sq,Skv,causal,window,k0", [
    (16, 16, True, 0, 0), (16, 16, False, 0, 0), (40, 40, True, 8, 0),
    (24, 12, True, 0, 12), (24, 12, True, 5, 6), (7, 30, False, 4, 0),
    (33, 33, True, 33, 0), (10, 8, True, 0, 16)])
def test_attention_pairs_match_the_mask(Sq, Skv, causal, window, k0):
    want = int(fa._mask(Sq, Skv, causal, window, "cpu", k0).sum())
    assert work.attention_pairs(Sq, Skv, causal, window, k0) == want


def _qkv(B=2, S=64, H=4, K=2, D=16):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, S, n, D, generator=g).requires_grad_()
            for n in (H, K, K)]


def test_recorder_counts_attention_by_formula():
    q, k, v = _qkv()
    B, S, H, D = q.shape
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    rec = _Recorder(None)
    with rec:
        out = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, plain)
    pairs = S * (S + 1) // 2
    assert rec.flops == 4 * D * B * H * pairs
    # only out and lse (saved for the backward) are held, not the scores
    assert rec.peak <= 2 * out.numel() * 4 + B * H * S * 4
    with rec:
        out.sum().backward()
    assert rec.flops == 14 * D * B * H * pairs


def test_recorder_counts_ssd_by_formula():
    g = torch.Generator().manual_seed(1)
    B, L, H, P, N, Q = 2, 48, 3, 8, 16, 32
    x = torch.randn(B, L, H, P, generator=g).requires_grad_()
    dt = torch.rand(B, L, H, generator=g).requires_grad_()
    a = -torch.rand(H, generator=g)
    b, c = (torch.randn(B, L, N, generator=g) for _ in range(2))
    plain = ss.ssd_scan_plain(x, dt, a, b, c, chunk=Q)
    rec = _Recorder(None)
    with rec:
        y, state = ss.ssd_scan(x, dt, a, b, c, chunk=Q)
    assert torch.equal(y, plain[0]) and torch.equal(state, plain[1])
    assert rec.flops == work.ssd_flops(B, L, H, P, N, Q)
    with rec:
        y.sum().backward()
    assert rec.flops == (work.ssd_flops(B, L, H, P, N, Q)
                         + work.ssd_flops(B, L, H, P, N, Q, backward=True))
