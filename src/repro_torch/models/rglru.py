"""RG-LRU recurrent block, RecurrentGemma / Griffin (port of
``repro.models.rglru``).

Linear recurrence h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t) with
input-dependent gates. Train/prefill runs a log-depth parallel scan over the
sequence (the reference's ``lax.associative_scan``); decode is an O(1) state
update. The recurrence/input gates are per-channel (diagonal), as in the
reference. Its ``constrain`` calls sit at the same points (no-ops outside a
mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import causal_conv, conv_step


def rglru_spec(cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.rglru.d_rnn or d
    w = cfg.rglru.conv_width
    f32 = torch.float32
    return {
        "w_x": ParamSpec((d, r), ("d_model", "d_rnn")),
        "w_gate": ParamSpec((d, r), ("d_model", "d_rnn")),
        "conv_k": ParamSpec((w, r), ("conv_w", "d_rnn")),
        "conv_b": ParamSpec((r,), ("d_rnn",), init="zeros"),
        "lam": ParamSpec((r,), ("d_rnn",), init="ones", dtype=f32),
        "a_w": ParamSpec((r,), ("d_rnn",), init="ones", dtype=f32),
        "a_b": ParamSpec((r,), ("d_rnn",), init="zeros", dtype=f32),
        "i_w": ParamSpec((r,), ("d_rnn",), init="ones", dtype=f32),
        "i_b": ParamSpec((r,), ("d_rnn",), init="zeros", dtype=f32),
        "w_out": ParamSpec((r, d), ("d_rnn", "d_model")),
    }


def _gates(p, cfg: ModelConfig, xb32):
    """(a, b) of the recurrence, in f32. ``jax.nn.softplus`` is
    ``logaddexp(x, 0)``; ``F.softplus`` returns x itself above x = 20,
    which differs from it by under 3e-9."""
    r_gate = torch.sigmoid(xb32 * p["a_w"] + p["a_b"])
    i_gate = torch.sigmoid(xb32 * p["i_w"] + p["i_b"])
    log_a = -cfg.rglru.c * F.softplus(p["lam"]) * r_gate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i_gate * xb32)


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1 with h_{-1} = 0, for a, b
    (B, L, ...). A log-depth (Hillis-Steele) scan: ceil(log2 L) steps, each
    composing every element with the one ``step`` places before it,
    (a1, b1) then (a2, b2) -> (a2*a1, a2*b1 + b2), as the reference's
    ``combine``. Products of a only: no exp of a cumulative log, which
    overflows f32 within a few dozen steps at c = 8."""
    L = a.shape[1]
    step = 1
    while step < L:
        b_next = b.clone()
        b_next[:, step:] += a[:, step:] * b[:, :-step]
        if 2 * step < L:              # the last step needs no new a
            a_next = a.clone()
            a_next[:, step:] *= a[:, :-step]
            a = a_next
        b = b_next
        step *= 2
    return b


def rglru_full(p, cfg: ModelConfig, x):
    """x (B,L,d) -> (y, state)."""
    w = cfg.rglru.conv_width
    xb = torch.einsum("bld,dr->blr", x, p["w_x"])
    conv_state = xb[:, -(w - 1):]            # the pre-conv input's tail
    xb = causal_conv(xb, p["conv_k"]) + p["conv_b"]
    xb = constrain(xb, "batch", "seq", "d_rnn")
    a, b = _gates(p, cfg, xb.float())
    h = constrain(linear_scan(a, b), "batch", "seq", "d_rnn")
    gate = F.gelu(torch.einsum("bld,dr->blr", x, p["w_gate"]).float(),
                  approximate="tanh")
    y = torch.einsum("blr,rd->bld", (h * gate).to(x.dtype), p["w_out"])
    return (constrain(y, "batch", "seq", "d_model"),
            {"h": h[:, -1], "conv": conv_state})


def rglru_decode(p, cfg: ModelConfig, x, state):
    """One token. x (B,1,d); state from rglru_state/rglru_full. Returns
    (y, new state)."""
    xb = torch.einsum("bld,dr->blr", x, p["w_x"])
    xb, conv_state = conv_step(xb, state["conv"], p["conv_k"])
    xb = xb + p["conv_b"]
    a, b = _gates(p, cfg, xb[:, 0].float())
    h = constrain(a * state["h"] + b, "batch", "d_rnn")
    gate = F.gelu(torch.einsum("bld,dr->blr", x, p["w_gate"]).float(),
                  approximate="tanh")[:, 0]
    y = torch.einsum("br,rd->bd", (h * gate).to(x.dtype), p["w_out"])
    return (constrain(y[:, None], "batch", "seq", "d_model"),
            {"h": h, "conv": conv_state})


def rglru_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                device="cuda"):
    r = cfg.rglru.d_rnn or cfg.d_model
    w = cfg.rglru.conv_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, w - 1, r), dtype=dtype,
                                device=device)}


def rglru_state_axes():
    return {"h": ("batch", "d_rnn"), "conv": ("batch", "conv_w", "d_rnn")}
