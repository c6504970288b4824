"""The comparison that decides ``correct``.

For every sampled row the window's INFERs computed for a request
(``serve.Reservoir``), the program's logits against the plain float32
reference's on the same weights and inputs (``configs/<config>.py``'s
``compare``):

``top1_gap``   the widest gap by which the logit of the class or token the
               program puts first lies below the reference's best
               (infinite when the program's first is no class or token of
               the reference, e.g. vocabulary padding, or not finite);
``logit_err``  the largest of each row's max |program - reference| over
               the row's max |reference|.

Each that the configuration names in its ``limits`` is held to that
limit (a number that its control does not separate from sound runs is
not named, and only reported);
``unanswered``, the window's requests with no status once the drain has
ended, to 0. The control (``tools/control.py``) reads the same numbers
with the reference in a lower precision in the program's place.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

NAMES = ("top1_gap", "logit_err")


def row_numbers(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """The two numbers over a block of rows: prog (rows, >= V), ref (rows,
    V), both float32 on one device."""
    v = ref.shape[1]
    if not bool(torch.isfinite(prog).all()):
        return {"top1_gap": math.inf, "logit_err": math.inf}
    first = prog.argmax(dim=1)
    if bool((first >= v).any()):
        gap = math.inf
    else:
        best = ref.max(dim=1).values
        gap = float((best - ref.gather(1, first[:, None])[:, 0]).max())
    err = (prog[:, :v] - ref).abs().amax(dim=1) \
        / ref.abs().amax(dim=1).clamp_min(1e-30)
    return {"top1_gap": gap, "logit_err": float(err.max())}


def numbers(triples: Iterable) -> Dict[str, float]:
    """The widest of each number over (samples, program, reference)
    blocks, and how many rows they hold."""
    out = {n: 0.0 for n in NAMES}
    rows = 0
    for _, prog, ref in triples:
        got = row_numbers(prog.to(ref.device), ref)
        for n in NAMES:
            out[n] = max(out[n], got[n])
        rows += ref.shape[0]
    out["rows"] = rows
    return out


def checks(found: Dict[str, float], limits: Dict[str, float],
           unanswered: int) -> Dict[str, Dict[str, float]]:
    """{name: {value, limit}} of the numbers the configuration compares
    (those its ``limits`` name), then ``unanswered``."""
    out = {n: {"value": found[n], "limit": limits[n]} for n in NAMES
           if n in limits}
    out["unanswered"] = {"value": unanswered, "limit": 0}
    return out


def passed(chk: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
