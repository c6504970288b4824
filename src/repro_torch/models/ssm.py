"""Mamba2 (state-space duality) mixer block (port of ``repro.models.ssm``).

Prefill runs the chunked SSD scan through ``kernels.ops.ssd``: the
hand-written CUDA kernel on the card, its plain PyTorch version
(``kernels.ssd_scan.ssd_scan_plain``, the port of the reference's
``ssd_reference``) on the CPU. Decode is an O(1) state
update. The reference's ``constrain`` calls sit at the same points (no-ops
outside a mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops
from repro_torch.models.params import ParamSpec


def mamba_spec(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    h = (d * s.expand) // s.head_dim        # number of SSD heads
    p, n, w = s.head_dim, s.d_state, s.conv_width
    return {
        "w_x": ParamSpec((d, h, p), ("d_model", "ssm_heads", "ssm_hd")),
        "w_z": ParamSpec((d, h, p), ("d_model", "ssm_heads", "ssm_hd")),
        "w_b": ParamSpec((d, n), ("d_model", "ssm_state")),
        "w_c": ParamSpec((d, n), ("d_model", "ssm_state")),
        "w_dt": ParamSpec((d, h), ("d_model", "ssm_heads")),
        "b_dt": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "a_log": ParamSpec((h,), ("ssm_heads",), init="ones",
                           dtype=torch.float32),
        "d_skip": ParamSpec((h,), ("ssm_heads",), init="ones",
                            dtype=torch.float32),
        "conv_x": ParamSpec((w, h, p), ("conv_w", "ssm_heads", "ssm_hd")),
        "conv_b": ParamSpec((w, n), ("conv_w", "ssm_state")),
        "conv_c": ParamSpec((w, n), ("conv_w", "ssm_state")),
        "norm": ParamSpec((h, p), ("ssm_heads", "ssm_hd"), init="zeros",
                          dtype=torch.float32),
        "w_out": ParamSpec((h, p, d), ("ssm_heads", "ssm_hd", "d_model")),
    }


def ssm_heads(cfg: ModelConfig) -> int:
    return (cfg.d_model * cfg.ssm.expand) // cfg.ssm.head_dim


def causal_conv(x, kern):
    """Depthwise causal conv along dim 1. x (B,L,*C); kern (w,*C)."""
    w = kern.shape[0]
    L = x.shape[1]
    # w-1 zeros before the sequence (by torch.cat: DTensor's F.pad returns
    # placements for a one-dim mesh in torch 2.11)
    xp = torch.cat([x.new_zeros((x.shape[0], w - 1) + tuple(x.shape[2:])),
                    x], dim=1)
    y = torch.zeros_like(x, dtype=torch.float32)    # a DTensor's: local
    for i in range(w):
        y = y + kern[i].float() * xp[:, i:i + L].float()
    return y.to(x.dtype)


def conv_step(x_new, state, kern):
    """One-token conv. x_new (B,1,*C); state (B,w-1,*C)."""
    full = torch.cat([state, x_new], dim=1)
    y = sum(kern[i].float() * full[:, i].float()
            for i in range(kern.shape[0]))
    return y[:, None].to(x_new.dtype), full[:, 1:]


def _branches(p, cfg: ModelConfig, x):
    """Project input to SSD operands (pre-conv)."""
    xh = torch.einsum("bld,dhp->blhp", x, p["w_x"])
    z = torch.einsum("bld,dhp->blhp", x, p["w_z"])
    b = torch.einsum("bld,dn->bln", x, p["w_b"])
    c = torch.einsum("bld,dn->bln", x, p["w_c"])
    dt = F.softplus(torch.einsum("bld,dh->blh", x.float(), p["w_dt"].float())
                    + p["b_dt"].float())
    return xh, z, b, c, dt


def _finish(p, cfg: ModelConfig, y, z, xh):
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    g = y * F.silu(z.float())
    # the mean over ssm_hd, summed over its shards, and its gradient
    # replicated: else DTensor reduce-scatters that gradient over the
    # sequence, and the gate's and z's gradients follow it there
    var = constrain(g.square().mean(dim=(-2, -1), keepdim=True), "batch",
                    "seq", None, None)
    g = g * torch.rsqrt(var + 1e-6) * (1.0 + p["norm"])
    g = constrain(g.to(xh.dtype), "batch", "seq", "ssm_heads", "ssm_hd")
    return torch.einsum("blhp,hpd->bld", g, p["w_out"])


def _silu(t, dtype):
    return F.silu(t.float()).to(dtype)


def mamba_full(p, cfg: ModelConfig, x):
    """Train/prefill. x (B,L,d) -> (y, state dict)."""
    s = cfg.ssm
    xh, z, b, c, dt = _branches(p, cfg, x)
    tail = s.conv_width - 1                       # pre-activation tails
    state = {"conv_x": xh[:, -tail:], "conv_b": b[:, -tail:],
             "conv_c": c[:, -tail:]}
    xh = _silu(causal_conv(xh, p["conv_x"]), x.dtype)
    b = _silu(causal_conv(b, p["conv_b"]), x.dtype)
    c = _silu(causal_conv(c, p["conv_c"]), x.dtype)
    xh = constrain(xh, "batch", "seq", "ssm_heads", "ssm_hd")
    a = -torch.exp(p["a_log"])
    y, state["ssm"] = ops.ssd(xh, dt, a, b, c, chunk=s.chunk)
    out = _finish(p, cfg, y.float(), z, xh)
    return constrain(out, "batch", "seq", "d_model"), state


def mamba_decode(p, cfg: ModelConfig, x, state):
    """One token. x (B,1,d); state from mamba_state/mamba_full. Returns
    (y, new state)."""
    xh, z, b, c, dt = _branches(p, cfg, x)
    xh, cx = conv_step(xh, state["conv_x"], p["conv_x"])
    b, cb = conv_step(b, state["conv_b"], p["conv_b"])
    c, cc = conv_step(c, state["conv_c"], p["conv_c"])
    xh, b, c = _silu(xh, x.dtype), _silu(b, x.dtype), _silu(c, x.dtype)
    a = -torch.exp(p["a_log"])                        # (H,)
    dA = torch.exp(dt[:, 0] * a)                      # (B,H)
    xdt = xh[:, 0].float() * dt[:, 0, :, None]
    s_new = (state["ssm"] * dA[:, :, None, None]
             + torch.einsum("bhp,bn->bhpn", xdt, b[:, 0].float()))
    s_new = constrain(s_new, "batch", "ssm_heads", "ssm_hd", "ssm_state")
    y = torch.einsum("bhpn,bn->bhp", s_new, c[:, 0].float())
    out = _finish(p, cfg, y[:, None], z, xh)
    return constrain(out, "batch", "seq", "d_model"), {"ssm": s_new, "conv_x": cx, "conv_b": cb, "conv_c": cc}


def mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                device="cuda"):
    s = cfg.ssm
    h = ssm_heads(cfg)
    w = s.conv_width - 1
    return {
        "ssm": torch.zeros((batch, h, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, w, h, s.head_dim), dtype=dtype,
                              device=device),
        "conv_b": torch.zeros((batch, w, s.d_state), dtype=dtype,
                              device=device),
        "conv_c": torch.zeros((batch, w, s.d_state), dtype=dtype,
                              device=device),
    }


def mamba_state_axes():
    return {
        "ssm": ("batch", "ssm_heads", "ssm_hd", "ssm_state"),
        "conv_x": ("batch", "conv_w", "ssm_heads", "ssm_hd"),
        "conv_b": ("batch", "conv_w", "ssm_state"),
        "conv_c": ("batch", "conv_w", "ssm_state"),
    }
