"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the run is driven on the CPU at
a tiny size) and the rest of the run is the benchmark's own. One case per
fault a serving cell can have (``faults.py``): an answer altered where it
is produced, half of the batch left out (the rest filled with the mean of
the rows computed), and for the decode step a state left unchanged (the
new token's key and value never written to the cache) and the wrong slots
of the cache attended (every slot, or the new token's alone). Each is
caught by the comparison itself, on rows that were compared. A sound run
of the same cell is correct."""
from pathlib import Path

import pytest

from perfbench.harness.cell import run_cell
from perfbench.tests import faults
from perfbench.tests.tiny import QWEN2, RESNET

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 99
CELLS = {"resnet50.poisson": RESNET, "qwen2-0.5b.decode": QWEN2}
SEEDS = (SEED, SEED + 1, SEED + 2, SEED + 3)
# INFERs carry several requests only where requests queue during one: at
# this rate most tiny runs have some that do, not every run (the
# scheduler's, PERF.md)
BATCHING_RATE = 200


def _run(cell, fault=None, rate=None, seed=SEED):
    """A tiny run's outcome; at ``rate`` INFERs may carry several requests
    each, so that a fault in the batch's later rows reaches answered rows."""
    over = CELLS[cell]
    if rate is not None:
        over = {**over, "traffic": {**over["traffic"], "rate": rate}}
    return run_cell(ROOT, cell, seed, 2, False, device="cpu",
                    overrides=over, fault=fault)


def _caught(r):
    """Not correct, and for a compared number over its limit."""
    numbers = [c for n, c in r["checks"].items() if n != "unanswered"]
    return not r["correct"] and any(c["value"] > c["limit"] for c in numbers)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    r = _run(cell).result
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [faults.alter_answer, faults.half_batch],
                         ids=["answer_altered", "half_batch"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    """Every run on which the fault reached an answered row is caught (half
    a batch: a run whose window had an INFER of two requests or more), and
    at least one of the seeds' runs did."""
    reached = 0
    for seed in SEEDS:
        out = _run(cell, fault, rate=BATCHING_RATE, seed=seed)
        if fault is faults.half_batch and not out.summary["batched"]:
            continue
        assert _caught(out.result), (seed, out.result["checks"])
        reached += 1
    assert reached


def test_a_decode_step_that_leaves_its_state_unchanged_is_not_correct(
        monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_write_slot", attention._write_slot)
    r = _run("qwen2-0.5b.decode", faults.unchanged_state).result
    assert _caught(r), r["checks"]


@pytest.mark.parametrize("fault", [faults.every_slot, faults.own_slot],
                         ids=["every_slot", "own_slot"])
def test_a_decode_step_that_reads_the_wrong_slots_is_not_correct(
        monkeypatch, fault):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "flash_decode", ops.flash_decode)
    r = _run("qwen2-0.5b.decode", fault).result
    assert _caught(r), r["checks"]
